# Copyright (c) 2026
# MIT License
"""Auxiliary-data path handling and vertex-buffer construction.

Equivalent of reference ``horayzon/auxiliary.py`` (get_path_aux_data
auxiliary.py:12, rearrange_pad_buffer :49, pad_buffer :100).  The buffer
format (flat interleaved x/y/z float32, padded to a 16-byte multiple) is kept
for drop-in compatibility even though the sweep kernels consume the decomposed
heightfield (:mod:`horayzon_tpu.terrain`) — the padding requirement stemmed
from Embree's SSE loads and is now only a compatibility no-op.
"""

import os

import numpy as np


def get_path_aux_data():
    """Directory for downloaded auxiliary data (geoid grids, coastlines).

    Unlike the reference (which interactively prompts and persists the path
    next to the installed package, auxiliary.py:23-42), this resolves, in
    order: the ``HORAYZON_TPU_AUX_DATA`` environment variable, then
    ``~/.cache/horayzon_tpu/``; the directory is created if needed."""
    path = os.environ.get("HORAYZON_TPU_AUX_DATA")
    if path is None:
        path = os.path.join(os.path.expanduser("~"), ".cache",
                            "horayzon_tpu")
    path = os.path.join(path, "")
    os.makedirs(path, exist_ok=True)
    return path


def rearrange_pad_buffer(x, y, z):
    """Interleave x/y/z into a flat float32 buffer and pad (auxiliary.py:49).

    Parameters
    ----------
    x, y, z : ndarray of float32, shape (H, W)

    Returns
    -------
    buffer : ndarray of float32, one-dimensional
    """
    if (not isinstance(x, np.ndarray) or not isinstance(y, np.ndarray)
            or not isinstance(z, np.ndarray)):
        raise TypeError("One or more input arguments are of invalid type")
    if ((x.dtype != np.float32) or (y.dtype != np.float32)
            or (z.dtype != np.float32)):
        raise TypeError("Not all input arguments are 32-bit floats")
    if (any(i.ndim != 2 for i in (x, y, z))
            or not x.shape == y.shape == z.shape):
        raise ValueError("Dimensions of input arguments are "
                         "erroneous/inconsistent")
    buffer = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1).ravel()
    return pad_buffer(np.ascontiguousarray(buffer))


def pad_buffer(buffer):
    """Pad a flat geometry buffer to a 16-byte multiple (auxiliary.py:100)."""
    if not isinstance(buffer, np.ndarray):
        raise ValueError("argument 'buffer' has invalid type")
    if buffer.ndim != 1:
        raise ValueError("argument 'buffer' must be one-dimensional")
    add_elem = 16
    if not (buffer.nbytes % 16) == 0:
        add_elem += ((16 - (buffer.nbytes % 16)) // buffer.itemsize)
    return np.append(buffer, np.zeros(add_elem, dtype=buffer.dtype))

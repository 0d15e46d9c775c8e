# Copyright (c) 2026
# MIT License
"""Device-mesh construction helpers.

The reference's shared-memory work distribution (TBB ``parallel_reduce`` over
grid rows, horizon_comp.cpp:739-800) maps here to a 2-D ``jax.sharding.Mesh``
over (grid-row tiles) x (azimuth shards).  The mesh follows the algorithm
only: XLA hands the few collectives (output gather, gradient psum) to the
platform's collective library, so no separate backend code is needed.
"""

import numpy as np

import jax
from jax.sharding import Mesh


AXIS_TILE = "tile"
AXIS_AZIM = "azim"


def make_mesh(n_tile=None, n_azim=1, devices=None):
    """Create a (tile, azim) mesh over the available devices.

    ``n_tile`` defaults to ``len(devices) // n_azim``."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_tile is None:
        if n_dev % n_azim != 0:
            raise ValueError("device count not divisible by n_azim")
        n_tile = n_dev // n_azim
    if n_tile * n_azim != n_dev:
        raise ValueError(f"mesh {n_tile}x{n_azim} != {n_dev} devices")
    dev_array = np.array(devices).reshape(n_tile, n_azim)
    return Mesh(dev_array, (AXIS_TILE, AXIS_AZIM))

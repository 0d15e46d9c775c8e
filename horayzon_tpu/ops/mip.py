# Copyright (c) 2026
# MIT License
"""Conservative max-mip pyramid over a heightfield.

Replaces the Embree BVH (reference horizon_comp.cpp:101-231) as the far-field
acceleration structure: level ``l`` stores the maximum elevation over aligned
``2^l x 2^l`` blocks of the outer DEM, so a single coarse sample bounds the
terrain over a whole footprint.  Out-of-domain padding uses a large negative
sentinel so off-grid samples never contribute to the horizon.

These are plain jnp functions; they are traced inside the jitted sweep entry
points (and are differentiable: gradients flow through the max-pools).
"""

import jax.numpy as jnp

# Safely below any terrestrial elevation; kept small in magnitude so that
# products with direction components stay finite in float32.
PAD_VALUE = -3.0e4


def max_downsample2(z):
    """2x2 max-pool with sentinel padding to even dimensions.

    Row-pair max first (strided row slices), then column-pair max.  Plain
    slice+maximum stays fully reverse-differentiable (lax.reduce_window
    with max is not)."""
    h, w = z.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        z = jnp.pad(z, ((0, ph), (0, pw)), constant_values=PAD_VALUE)
    r = jnp.maximum(z[0::2, :], z[1::2, :])
    return jnp.maximum(r[:, 0::2], r[:, 1::2])


def build_pyramid(z, num_levels):
    """Return [level0, ..., level_{num_levels-1}] (level0 is ``z`` itself)."""
    levels = [z]
    for _ in range(num_levels - 1):
        levels.append(max_downsample2(levels[-1]))
    return levels


def pad_level(z, pad):
    """Pad a pyramid level by ``pad`` cells of the sentinel on all sides."""
    if pad == 0:
        return z
    return jnp.pad(z, int(pad), constant_values=PAD_VALUE)


def padded_pyramid(z, num_levels, pads):
    """Build the pyramid and pad each level (``pads``: one int per level)."""
    levels = build_pyramid(z, num_levels)
    return [pad_level(lv, p) for lv, p in zip(levels, pads)]

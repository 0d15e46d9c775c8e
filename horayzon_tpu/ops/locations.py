# Copyright (c) 2026
# MIT License
"""Horizon sweep for arbitrary point locations.

Equivalent of reference ``horizon_locations_comp``
(horizon_comp.cpp:828-1094).  The location count is small (the reference
iterates locations with TBB, :926-931), so this path uses batched gathers
from the heightfield pyramid — shapes (L, A, M) — rather than the
shifted-slice trick of the gridded sweep.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from horayzon_tpu.ops import mip as _mip
from horayzon_tpu.ops import sweep as _sweep

_NEG = -3.0e38

#: Memory guard for the dense (L, A, M) phase temporaries: locations are
#: processed in chunks so no single gather array exceeds this many f32
#: elements (32 Mi elements = 128 MiB/array; ~6 such temporaries live at
#: once).  The reference only ever runs dozens of locations (TBB over
#: locations, horizon_comp.cpp:926-931); this keeps thousands of locations
#: within bounded memory instead of silently blowing up.
MAX_GATHER_ELEMS = 32 * 2 ** 20


def _bilinear_gather(z, fi, fj):
    """Bilinear sample of (H, W) array at fractional indices (any shape)."""
    h, w = z.shape
    i0 = jnp.clip(jnp.floor(fi).astype(jnp.int32), 0, h - 2)
    j0 = jnp.clip(jnp.floor(fj).astype(jnp.int32), 0, w - 2)
    wi = jnp.clip(fi - i0, 0.0, 1.0)
    wj = jnp.clip(fj - j0, 0.0, 1.0)
    v00 = z[i0, j0]
    v01 = z[i0, j0 + 1]
    v10 = z[i0 + 1, j0]
    v11 = z[i0 + 1, j0 + 1]
    top = (1 - wj) * v00 + wj * v01
    bot = (1 - wj) * v10 + wj * v11
    return (1 - wi) * top + wi * bot


@functools.partial(jax.jit, static_argnames=("sched_meta", "grid_meta",
                                             "elev_bounds"))
def _locations_core(levels, s_phases, coords, basis, ray_org_elev, trig, *,
                    sched_meta, grid_meta, elev_bounds):
    x0, y0, dx, dy, H, W = grid_meta
    lo, hi = elev_bounds
    sin_a, cos_a = trig               # (A,)
    east, north, norm = basis         # (L, 3) each

    # Per-(loc, azim) in-plane direction u and horizontal marching direction
    u3 = (sin_a[None, :, None] * east[:, None, :]
          + cos_a[None, :, None] * north[:, None, :])      # (L, A, 3)
    u_xy = u3[..., :2]
    u_xy = u_xy / jnp.maximum(
        jnp.linalg.norm(u_xy, axis=-1, keepdims=True), 1e-12)

    # Observer surface elevation: heightfield sample at the location
    # (replaces the +/- normal intersection ray, horizon_comp.cpp:944-957).
    fi_loc = (coords[:, 1] - y0) / dy
    fj_loc = (coords[:, 0] - x0) / dx
    z_terr = _bilinear_gather(levels[0], fi_loc, fj_loc)    # (L,)
    z_org = z_terr + ray_org_elev * norm[:, 2]              # (L,)

    a_n = (u_xy[..., 0] * norm[:, None, 0]
           + u_xy[..., 1] * norm[:, None, 1])               # (L, A)
    a_u = (u_xy[..., 0] * u3[..., 0] + u_xy[..., 1] * u3[..., 1])
    nz = norm[:, None, 2]
    uz = u3[..., 2]

    best_ratio = jnp.full(u_xy.shape[:2], _NEG, dtype=jnp.float32)
    best_s = jnp.zeros(u_xy.shape[:2], dtype=jnp.float32)

    for p, (kind, level, *_rest) in enumerate(sched_meta):
        s = s_phases[p]                                     # (M,)
        zl = levels[level]
        k = 2 ** level
        px = coords[:, None, None, 0] + s[None, None, :] * u_xy[..., 0:1]
        py = coords[:, None, None, 1] + s[None, None, :] * u_xy[..., 1:2]
        fi = (py - y0) / dy
        fj = (px - x0) / dx
        valid = ((fi >= 0.0) & (fi <= H - 1.001)
                 & (fj >= 0.0) & (fj <= W - 1.001))
        if level == 0:
            h = _bilinear_gather(zl, fi, fj)
        else:
            hl, wl = zl.shape
            ii = jnp.clip(jnp.floor(fi).astype(jnp.int32) // k, 0, hl - 1)
            jj = jnp.clip(jnp.floor(fj).astype(jnp.int32) // k, 0, wl - 1)
            h = zl[ii, jj]
        dh = h - z_org[:, None, None]
        num = s[None, None, :] * a_n[..., None] + dh * nz[..., None]
        den = s[None, None, :] * a_u[..., None] + dh * uz[..., None]
        ratio = jnp.where(
            den > 1e-6, num / jnp.maximum(den, 1e-6),
            jnp.where(num > 0.0, -_NEG, _NEG))
        ratio = jnp.where(valid, ratio, _NEG)
        idx = jnp.argmax(ratio, axis=-1)
        r_max = jnp.take_along_axis(ratio, idx[..., None], axis=-1)[..., 0]
        s_max = s[idx]
        upd = r_max > best_ratio
        best_s = jnp.where(upd, s_max, best_s)
        best_ratio = jnp.maximum(best_ratio, r_max)

    hori = jnp.clip(jnp.arctan(best_ratio), lo, hi)
    dist = best_s / jnp.maximum(jnp.cos(hori), 1e-6)
    return hori, dist


def horizon_locations_sweep(z, grid, coords, vec_norm, vec_north, azim,
                            dist_search_m, hori_acc, elev_ang_low_lim,
                            ray_org_elev, elev_ang_up_lim=89.98,
                            rel_err=None):
    """Compute per-location horizon (and distance-to-horizon).

    Returns (hori (L, A) float32 [radian], dist (L, A) float32 [metre]).
    """
    z = jnp.asarray(z, dtype=jnp.float32)
    step = min(abs(grid.dx), abs(grid.dy))
    if rel_err is None:
        rel_err = _sweep.default_rel_err(hori_acc)
    schedule = _sweep.build_schedule(step, dist_search_m, rel_err)
    levels = _mip.build_pyramid(z, schedule.num_levels)
    east = np.cross(vec_north, vec_norm)
    basis = (jnp.asarray(east, dtype=jnp.float32),
             jnp.asarray(vec_north, dtype=jnp.float32),
             jnp.asarray(vec_norm, dtype=jnp.float32))
    azim = np.asarray(azim, dtype=np.float64)
    trig = (jnp.asarray(np.sin(azim), dtype=jnp.float32),
            jnp.asarray(np.cos(azim), dtype=jnp.float32))
    h, w = z.shape
    s_phases = tuple(jnp.asarray(s) for s in schedule.s_values)
    coords = np.asarray(coords, dtype=np.float32)
    ray_org_elev = np.atleast_1d(np.asarray(ray_org_elev, dtype=np.float32))
    kw = dict(sched_meta=schedule.meta(),
              grid_meta=(grid.x0, grid.y0, grid.dx, grid.dy, h, w),
              elev_bounds=(math.radians(elev_ang_low_lim),
                           math.radians(elev_ang_up_lim)))

    num_loc = coords.shape[0]
    a_num = len(azim)
    m_max = max(len(s) for s in schedule.s_values)
    chunk = max(1, MAX_GATHER_ELEMS // max(a_num * m_max, 1))
    if num_loc <= chunk:
        return _locations_core(tuple(levels), s_phases,
                               jnp.asarray(coords), basis,
                               jnp.asarray(ray_org_elev), trig, **kw)

    # Chunk over locations within the memory budget; pad the tail chunk so
    # every call shares one compiled executable.
    if len(ray_org_elev) == 1:
        ray_org_elev = np.repeat(ray_org_elev, num_loc)
    east_np, north_np, norm_np = (np.asarray(b) for b in basis)
    hori_parts, dist_parts = [], []
    for lo_i in range(0, num_loc, chunk):
        hi_i = min(lo_i + chunk, num_loc)
        pad = chunk - (hi_i - lo_i)

        def tail_pad(a):
            return np.concatenate(
                [a[lo_i:hi_i], np.repeat(a[hi_i - 1:hi_i], pad, axis=0)]) \
                if pad else a[lo_i:hi_i]

        basis_c = tuple(jnp.asarray(tail_pad(b))
                        for b in (east_np, north_np, norm_np))
        hori_c, dist_c = _locations_core(
            tuple(levels), s_phases, jnp.asarray(tail_pad(coords)),
            basis_c, jnp.asarray(tail_pad(ray_org_elev)), trig, **kw)
        hori_parts.append(hori_c[:hi_i - lo_i])
        dist_parts.append(dist_c[:hi_i - lo_i])
    return (jnp.concatenate(hori_parts, axis=0),
            jnp.concatenate(dist_parts, axis=0))

# Copyright (c) 2026
# MIT License
"""Multi-resolution terrain: full-resolution inner grid + coarse far field.

Replacement for the reference's simplified outer TIN
(examples/horizon/gridded_planar_DEM_2m.py:130-265, where the outer domain is
decimated with the external `hmm` tool under a vertical error budget and
attached to the Embree scene as extra triangles, horizon_comp.cpp:199-218).

Here the far field is a *coarse heightfield* (e.g. the same DEM at 2^r times
the grid spacing).  The sweep's mip pyramid is assembled from both sources:

* levels ``l < r`` come from the fine grid — they are only read in the dense
  and near-mip phases, which the schedule keeps within the fine grid's halo;
* levels ``l >= r`` come from max-mips of the coarse grid, which covers the
  full search distance.

The accuracy contract matches the reference's two-component error budget
(`hori_acc = [algorithm, simplification]`): the far-field angular error is
bounded by ``coarse cell size / distance``, which the schedule keeps at
``<= rel_err`` by construction.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from horayzon_tpu.ops import mip as _mip
from horayzon_tpu.ops import sweep as _sweep


def combined_pyramid(z_fine, z_coarse, ratio_log2, coarse_offset, schedule):
    """Assemble padded pyramid levels from a fine and a coarse heightfield.

    Parameters
    ----------
    z_fine : (Hf, Wf) float32
        Full-resolution grid (inner domain + halo).
    z_coarse : (Hc, Wc) float32
        Coarse grid with spacing ``2**ratio_log2 *`` fine spacing, covering
        the full search distance around the inner domain.
    ratio_log2 : int
        log2 of the coarse/fine spacing ratio.
    coarse_offset : (oi, oj)
        Position of fine cell (0, 0) within the coarse grid, in *fine* cells
        (must be multiples of ``2**ratio_log2``; i.e. the grids are aligned).
    schedule : ops.sweep.Schedule

    Returns
    -------
    pyramid : tuple of padded jnp arrays (one per schedule level)
    """
    r = 2 ** ratio_log2
    oi, oj = coarse_offset
    if oi % r or oj % r:
        raise ValueError("coarse_offset must be multiples of the spacing "
                         "ratio (aligned grids)")
    pads = schedule.pads
    num_levels = len(pads)
    hf, wf = z_fine.shape
    # jnp throughout: the assembly stays traced so gradients reach
    # z_coarse (all slice bounds are static Python ints)
    z_coarse = jnp.asarray(z_coarse, dtype=jnp.float32)
    hc, wc = z_coarse.shape

    fine_levels = _mip.build_pyramid(jnp.asarray(z_fine, jnp.float32),
                                     min(ratio_log2, num_levels))
    pyramid = [_mip.pad_level(fine_levels[lvl], pads[lvl])
               for lvl in range(min(ratio_log2, num_levels))]

    if num_levels <= ratio_log2:
        return tuple(pyramid)

    # ---- Coarse-derived levels (l >= ratio_log2) ------------------------
    # Fine-aligned level-r cell q covers fine rows [q*r, (q+1)*r) and maps
    # to coarse cell q + oi//r.  Assemble a level-r array over
    # q in [-p0, span + p0) with coarse data where available, so shifts in
    # every direction read real far-field terrain; then mip it down.
    nl = num_levels - ratio_log2
    align = 2 ** nl
    need = max(pads[lvl] * (2 ** (lvl - ratio_log2))
               for lvl in range(ratio_log2, num_levels)) + 2
    p0 = ((need + align - 1) // align) * align

    def build_axis(size_f, off_c, size_c):
        span = (size_f + r - 1) // r
        hi = span + ((need + align - 1) // align) * align
        lo = -p0
        n = hi - lo
        # coarse index of fine-aligned cell q: q + off_c
        q0 = max(lo, -off_c)
        q1 = min(hi, size_c - off_c)
        return lo, n, q0, q1

    ci, cj = oi // r, oj // r
    lo_i, n_i, qi0, qi1 = build_axis(hf, ci, hc)
    lo_j, n_j, qj0, qj1 = build_axis(wf, cj, wc)
    base = jnp.full((n_i, n_j), _mip.PAD_VALUE, dtype=jnp.float32)
    if qi1 > qi0 and qj1 > qj0:
        base = base.at[qi0 - lo_i:qi1 - lo_i, qj0 - lo_j:qj1 - lo_j].set(
            z_coarse[qi0 + ci:qi1 + ci, qj0 + cj:qj1 + cj])

    coarse_levels = _mip.build_pyramid(base, nl)
    for lvl in range(ratio_log2, num_levels):
        a = coarse_levels[lvl - ratio_log2]
        k = lvl - ratio_log2
        # current left offset (in level-l cells): p0 / 2^k (p0 is a
        # multiple of 2^nl >= 2^k, so this is exact)
        o = p0 >> k
        pad_l = pads[lvl]              # target left pad of this level
        if o >= pad_l:
            a = a[o - pad_l:, :][:, o - pad_l:]
        else:
            a = jnp.pad(a, ((pad_l - o, 0), (pad_l - o, 0)),
                        constant_values=_mip.PAD_VALUE)
        # right/bottom margin: slices reach (extent>>l) + 2*pad + Sz
        need_i = (hf >> lvl) + 2 * pads[lvl] + \
            _sweep._mip_slice_size(hf, lvl) + 4
        need_j = (wf >> lvl) + 2 * pads[lvl] + \
            _sweep._mip_slice_size(wf, lvl) + 4
        pad_i = max(0, need_i - a.shape[0])
        pad_j = max(0, need_j - a.shape[1])
        if pad_i or pad_j:
            a = jnp.pad(a, ((0, pad_i), (0, pad_j)),
                        constant_values=_mip.PAD_VALUE)
        pyramid.append(a)
    return tuple(pyramid)


def rasterize_tin(vert_simp, tri_ind_simp, *, origin_xy, spacing_xy, shape,
                  fill=_mip.PAD_VALUE):
    """Sample a TIN onto a regular lattice by barycentric interpolation.

    The reference attaches a simplified outer-domain TIN (built with the
    external ``hmm`` tool) directly to its Embree scene
    (horizon_comp.cpp:199-218); here the same TIN becomes a coarse far-
    field heightfield for :func:`horizon_sweep_multires`.

    Parameters
    ----------
    vert_simp : flat float32 array, interleaved (x, y, z) vertices
        (Embree-style padded buffers are fine — the tail is unreferenced).
    tri_ind_simp : flat int32 array of vertex indices, 3 per triangle.
    origin_xy : (x0, y0) of lattice point (0, 0).
    spacing_xy : (sx, sy) lattice spacings (sy signed, like ``dy``).
    shape : (H, W) lattice size.

    Returns
    -------
    (H, W) float32: TIN height at each lattice point; points covered by
    several triangles (skirts/seams) get the maximum (conservative for
    occlusion); points outside all triangles get ``fill``.
    """
    verts = np.asarray(vert_simp, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(tri_ind_simp, dtype=np.int64).reshape(-1, 3)
    x0, y0 = origin_xy
    sx, sy = spacing_xy
    h, w = shape
    out = np.full((h, w), fill, dtype=np.float64)

    # Vertex positions in (row, col) lattice coordinates
    vi = (verts[:, 1] - y0) / sy
    vj = (verts[:, 0] - x0) / sx
    vz = verts[:, 2]
    eps = 1.0e-9
    for a, b, c in tris:
        i_lo = max(int(np.ceil(min(vi[a], vi[b], vi[c]) - eps)), 0)
        i_hi = min(int(np.floor(max(vi[a], vi[b], vi[c]) + eps)), h - 1)
        j_lo = max(int(np.ceil(min(vj[a], vj[b], vj[c]) - eps)), 0)
        j_hi = min(int(np.floor(max(vj[a], vj[b], vj[c]) + eps)), w - 1)
        if i_hi < i_lo or j_hi < j_lo:
            continue
        ii, jj = np.meshgrid(np.arange(i_lo, i_hi + 1),
                             np.arange(j_lo, j_hi + 1), indexing="ij")
        # Barycentric coordinates of the lattice points
        d = ((vi[b] - vi[a]) * (vj[c] - vj[a])
             - (vj[b] - vj[a]) * (vi[c] - vi[a]))
        if abs(d) < 1.0e-12:
            continue
        wb = ((ii - vi[a]) * (vj[c] - vj[a])
              - (jj - vj[a]) * (vi[c] - vi[a])) / d
        wc = ((jj - vj[a]) * (vi[b] - vi[a])
              - (ii - vi[a]) * (vj[b] - vj[a])) / d
        wa = 1.0 - wb - wc
        tol = 1.0e-6
        inside = (wa >= -tol) & (wb >= -tol) & (wc >= -tol)
        if not inside.any():
            continue
        z_tri = wa * vz[a] + wb * vz[b] + wc * vz[c]
        block = out[i_lo:i_hi + 1, j_lo:j_hi + 1]
        np.maximum(block, np.where(inside, z_tri, fill), out=block)
    return out.astype(np.float32)


def coarse_grid_from_tin(vert_simp, tri_ind_simp, *, grid, fine_shape,
                         z_fine, ratio_log2, dist_search):
    """Build the multires coarse far field from a simplified outer TIN.

    The coarse lattice is aligned to the fine grid (spacing ``2**r`` fine
    cells), extends ``dist_search`` beyond it, and is filled from the TIN;
    over the fine grid's own extent the max-pooled fine terrain wins (the
    first coarse-phase samples can still land there).  Returns
    ``(z_coarse, coarse_offset)`` for :func:`horizon_sweep_multires`.
    """
    r = 2 ** ratio_log2
    hf, wf = fine_shape
    # pad the lattice by the search distance, in whole coarse cells
    pad_c = int(math.ceil(dist_search / (abs(grid.dx) * r))) + 2
    n_i = (hf + r - 1) // r + 2 * pad_c
    n_j = (wf + r - 1) // r + 2 * pad_c
    oi = oj = pad_c * r                     # fine cell 0 at coarse pad_c
    # The mip convention is block *maxima* (a lower coarse value could hide
    # far-field terrain).  Two ingredients approach the TIN's true
    # per-cell maximum from below within a tight bound:
    # (a) rasterise at `sub` x the coarse resolution and max-pool, which
    #     bounds the residual by the TIN gradient times the sub-cell size;
    # (b) scatter the TIN's own vertices (where piecewise-linear maxima
    #     live) into their containing cells.
    corner = (grid.x0 - oj * grid.dx, grid.y0 - oi * grid.dy)
    sub = min(r, 4)
    while sub > 1 and (n_i * sub) * (n_j * sub) > 2 * 10 ** 8:
        sub //= 2                            # cap host raster memory
    z_s = rasterize_tin(vert_simp, tri_ind_simp, origin_xy=corner,
                        spacing_xy=(grid.dx * r / sub, grid.dy * r / sub),
                        shape=(n_i * sub, n_j * sub))
    z_coarse = z_s.reshape(n_i, sub, n_j, sub).max(axis=(1, 3))
    verts3 = np.asarray(vert_simp, dtype=np.float64).reshape(-1, 3)
    tris3 = np.asarray(tri_ind_simp, dtype=np.int64).reshape(-1)
    used = verts3[np.unique(tris3)]
    ci_v = np.floor((used[:, 1] - corner[1]) / (grid.dy * r)).astype(int)
    cj_v = np.floor((used[:, 0] - corner[0]) / (grid.dx * r)).astype(int)
    ok = (ci_v >= 0) & (ci_v < n_i) & (cj_v >= 0) & (cj_v < n_j)
    np.maximum.at(z_coarse, (ci_v[ok], cj_v[ok]),
                  used[ok, 2].astype(np.float32))
    # overlay the fine grid's own max-pooled blocks (exact where known)
    hp = hf - hf % r
    wp = wf - wf % r
    pooled = np.asarray(z_fine)[:hp, :wp] \
        .reshape(hp // r, r, wp // r, r).max(axis=(1, 3))
    ci, cj = oi // r, oj // r
    z_coarse[ci:ci + hp // r, cj:cj + wp // r] = np.maximum(
        z_coarse[ci:ci + hp // r, cj:cj + wp // r], pooled)
    return z_coarse, (oi, oj)


def _validate_fine_halo(schedule, ratio_log2, step, offset, inner_shape,
                        fine_shape):
    """Raise if phases reading fine-derived levels can leave the fine
    grid's halo (they would sample sentinel padding instead of terrain)."""
    in0, in1 = inner_shape
    off0, off1 = offset
    hf, wf = fine_shape
    halo = min(off0, off1, hf - off0 - in0, wf - off1 - in1)
    s_fine_max = 0.0
    for ph, s_vals in zip(schedule.phases, schedule.s_values):
        if ph.level < ratio_log2:
            s_fine_max = max(s_fine_max, float(s_vals[-1]))
    halo_needed = int(math.ceil(s_fine_max / step)) + 2
    if halo < halo_needed:
        raise ValueError(
            f"fine-grid halo ({halo} cells) too small for the schedule: "
            f"phases below level {ratio_log2} march to {s_fine_max:.0f} m "
            f"(= {halo_needed} cells).  Widen the fine halo or use a "
            f"smaller spacing ratio.")
    return halo


def horizon_sweep_multires(z_fine, z_coarse, *, ratio_log2, coarse_offset,
                           dx, dy, offset, inner_shape, azim, dist_search,
                           hori_acc=0.25, elev_ang_low_lim=-15.0,
                           elev_ang_up_lim=89.98, ray_org_elev=0.01,
                           geom=None, u_xy=None, rel_err=None,
                           max_level=10):
    """Gridded horizon with a coarse far field.

    Same contract as :func:`horayzon_tpu.ops.sweep.horizon_sweep`, with the
    outer heightfield split into ``z_fine`` (inner + halo at full
    resolution) and ``z_coarse`` (far field at ``2**ratio_log2`` x spacing).

    The fine halo must be wide enough that all schedule phases at levels
    below ``ratio_log2`` stay inside the fine grid; a ValueError explains
    the required halo otherwise.
    """
    z_fine = jnp.asarray(z_fine, dtype=jnp.float32)
    step = min(abs(dx), abs(dy))
    if rel_err is None:
        rel_err = _sweep.default_rel_err(hori_acc)
    schedule = _sweep.build_schedule(step, dist_search, rel_err,
                                     max_level=max_level)

    in0, in1 = inner_shape
    off0, off1 = offset
    hf, wf = z_fine.shape
    _validate_fine_halo(schedule, ratio_log2, step, offset, inner_shape,
                        z_fine.shape)

    pyramid = combined_pyramid(z_fine, z_coarse, ratio_log2, coarse_offset,
                               schedule)
    azim = np.asarray(azim, dtype=np.float64)
    tables_np = _sweep.horizon_shift_tables(schedule, azim, dx, dy, offset,
                                            u_xy=u_xy)
    tables = jax.tree_util.tree_map(jnp.asarray, tables_np)
    if u_xy is None:
        u_xy = np.stack([np.sin(azim), np.cos(azim)], axis=-1)
    trig = {
        "sin": jnp.asarray(np.sin(azim), dtype=jnp.float32),
        "cos": jnp.asarray(np.cos(azim), dtype=jnp.float32),
        "ux": jnp.asarray(u_xy[:, 0], dtype=jnp.float32),
        "uy": jnp.asarray(u_xy[:, 1], dtype=jnp.float32),
    }
    z_inner = z_fine[off0:off0 + in0, off1:off1 + in1]
    planar = geom is None
    if planar:
        z_org = z_inner + jnp.float32(ray_org_elev)
        geom_in = None
    else:
        geom_in = {k: jnp.asarray(v, dtype=jnp.float32)
                   for k, v in geom.items()}
        z_org = z_inner + jnp.float32(ray_org_elev) * geom_in["mz"]

    hori, _ = _sweep._horizon_core(
        pyramid, z_org, z_inner, geom_in, tables, trig,
        sched_meta=schedule.meta(), pads=schedule.pads,
        inner_shape=tuple(inner_shape), planar=planar, track_dist=False,
        outer_shape=(hf, wf))
    lo = math.radians(elev_ang_low_lim)
    hi = math.radians(elev_ang_up_lim)
    return jnp.clip(hori, lo, hi)

# Copyright (c) 2026
# MIT License
"""Public horizon API, mirroring reference ``horayzon/horizon.pyx``.

``horizon_gridded`` (reference horizon.pyx:29) and ``horizon_locations``
(reference horizon.pyx:218) keep the reference's signatures so existing
pipelines can switch by changing the import.  Internally both run the
gather-free shifted-slice sweep in :mod:`horayzon_tpu.ops.sweep`, which XLA
compiles for the attached accelerator, instead of Embree ray casting.

Differences from the reference (documented behaviour):

* ``ray_algorithm`` selects among CPU search strategies in the reference
  (discrete_sampling / binary_search / guess_constant,
  horizon_comp.cpp:302-498).  Here a single batched sweep computes the
  exact maximum over distance samples, so the argument is accepted and
  ignored (any valid name, plus the native name ``"sweep"``).
* ``geom_type`` (Embree triangle/quad/grid) is accepted and ignored — the
  heightfield sweep always samples the bilinear surface, which matches the
  reference's "grid" geometry to within ``hori_acc``.
* The result is the exact sampled maximum rather than a bracket midpoint of
  the reference's ``hori_acc/5`` elevation ladder; agreement is within
  ``hori_acc``.
"""

import time

import numpy as np
import jax.numpy as jnp

from horayzon_tpu import terrain as _terrain
from horayzon_tpu.ops import sweep as _sweep

_VALID_ALGOS = ("discrete_sampling", "binary_search", "guess_constant",
                "sweep")
_VALID_GEOM = ("triangle", "quad", "grid")


def azimuth_angles(azim_num):
    """Azimuth angles [radian], clockwise from North (horizon.pyx:190-196)."""
    return ((2.0 * np.pi) / azim_num * np.arange(azim_num)).astype(np.float32)


def _mask_bbox(mask):
    """Bounding box (r0, r1, c0, c1) of unmasked (== 1) cells; the whole
    domain if every cell is unmasked, a 1x1 box if none is (callers fill
    masked cells afterwards, so the value computed there is discarded)."""
    rows = np.flatnonzero(np.asarray(mask).any(axis=1))
    cols = np.flatnonzero(np.asarray(mask).any(axis=0))
    if rows.size == 0:
        return 0, 1, 0, 1
    return rows[0], rows[-1] + 1, cols[0], cols[-1] + 1


def horizon_gridded(
        vert_grid, dem_dim_0, dem_dim_1,
        vec_norm, vec_north,
        offset_0, offset_1,
        dist_search,
        azim_num=360,
        hori_acc=0.25,
        ray_algorithm="guess_constant",
        geom_type="grid",
        vert_simp=None, num_vert_simp=1,
        tri_ind_simp=None, num_tri_simp=1,
        elev_ang_low_lim=-15.0,
        mask=None,
        hori_fill=0.0,
        ray_org_elev=0.01,
        verbose=True):
    """Horizon computation for a gridded domain.

    Signature and semantics mirror reference horizon.pyx:29-197; rays against
    the DEM are replaced by the shifted-slice sweep (ops/sweep.py).  Masked
    runs sweep only the bounding box of unmasked cells.

    Returns
    -------
    hori : ndarray of float32, shape (in0, in1, azim_num) [radian]
    azim : ndarray of float32, shape (azim_num,) [radian]
    """
    # --- Validation (mirrors horizon.pyx:109-156) -------------------------
    vec_norm = np.asarray(vec_norm, dtype=np.float32)
    vec_north = np.asarray(vec_north, dtype=np.float32)
    if ((offset_0 + vec_norm.shape[0] > dem_dim_0)
            or (offset_1 + vec_norm.shape[1] > dem_dim_1)):
        raise ValueError("inconsistency between input arguments dem_dim_0, "
                         "dem_dim_1, offset_0, offset_1 and vec_norm")
    if vec_norm.size == 0:
        raise ValueError(
            "inner domain is empty (vec_norm has zero size) — the outer "
            "DEM is not larger than twice the search distance; widen the "
            "domain or reduce dist_search")
    if ((vec_norm.ndim != 3) or (vec_north.ndim != 3)
            or (vec_norm.shape != vec_north.shape)):
        raise ValueError("dimension (lengths) of vec_norm and/or vec_north "
                         "is/are erroneous")
    if ray_algorithm not in _VALID_ALGOS:
        raise ValueError("invalid input argument for ray_algorithm")
    if geom_type not in _VALID_GEOM:
        raise ValueError("invalid input argument for geom_type")
    if hori_acc > 10.0:
        raise ValueError("limit of hori_acc (10 degree) is exceeded")
    if mask is None:
        mask = np.ones((vec_norm.shape[0], vec_norm.shape[1]), dtype=np.uint8)
    mask = np.asarray(mask)
    if mask.shape != vec_norm.shape[:2]:
        raise ValueError("shape of mask is inconsistent with other input")
    if mask.dtype != np.uint8:
        raise TypeError("data type of mask must be 'uint8'")
    if ray_org_elev < 0.005:
        raise TypeError("minimal allowed value for 'ray_org_elev' is 0.005 m")

    x, y, z = _terrain.decompose_vert_grid(vert_grid, dem_dim_0, dem_dim_1)
    grid = _terrain.detect_regular_grid(x, y)
    inner_shape = (vec_norm.shape[0], vec_norm.shape[1])
    azim = azimuth_angles(azim_num)

    if (vert_simp is None) != (tri_ind_simp is None):
        raise ValueError("vert_simp and tri_ind_simp must be provided "
                         "together")
    if vert_simp is not None:
        # Simplified outer TIN (reference horizon.pyx:84-97 /
        # horizon_comp.cpp:199-218): rasterised to a coarse far-field
        # lattice and swept with the multi-resolution engine.
        if grid is None:
            raise ValueError("the simplified outer TIN (vert_simp) is "
                             "only supported on planar regular grids "
                             "(reference usage: gridded_planar_DEM_2m)")
        t0 = time.perf_counter()
        hori = _tin_gridded(
            z, grid, vert_simp, num_vert_simp, tri_ind_simp, num_tri_simp,
            offset=(offset_0, offset_1), inner_shape=inner_shape,
            azim_num=azim_num, dist_search_m=dist_search * 1000.0,
            hori_acc=hori_acc, elev_ang_low_lim=elev_ang_low_lim,
            ray_org_elev=ray_org_elev)
    elif grid is None:
        # Curved ENU mesh: planarise onto a regular lattice, sweep there,
        # then sample the horizon back at the original cell positions.
        t0 = time.perf_counter()
        hori = _curved_gridded(x, y, z, vec_norm, vec_north,
                               offset_0, offset_1, azim,
                               dist_search * 1000.0, hori_acc,
                               elev_ang_low_lim, ray_org_elev,
                               mask=mask if mask.min() == 0 else None)
    else:
        if _terrain.is_default_planar_vectors(vec_norm, vec_north):
            geom = None
            u_xy = None
        else:
            geom = _terrain.basis_fields(vec_norm, vec_north)
            u_xy = _terrain.mean_marching_directions(azim, vec_norm,
                                                     vec_north)

        t0 = time.perf_counter()
        # Mask-driven work reduction (reference skips masked cells,
        # horizon_comp.cpp:749): crop the sweep to the bounding box of
        # unmasked cells; outside-bbox cells get hori_fill below.
        r0, r1, c0, c1 = _mask_bbox(mask)
        if geom is not None and (r0, r1, c0, c1) != (
                0, inner_shape[0], 0, inner_shape[1]):
            geom_c = {k: v[r0:r1, c0:c1] for k, v in geom.items()}
        else:
            geom_c = geom
        hori_c, _ = _sweep.horizon_sweep(
            z, dx=grid.dx, dy=grid.dy,
            offset=(offset_0 + r0, offset_1 + c0),
            inner_shape=(r1 - r0, c1 - c0), azim=azim,
            dist_search=dist_search * 1000.0,
            hori_acc=hori_acc, elev_ang_low_lim=elev_ang_low_lim,
            ray_org_elev=ray_org_elev, geom=geom_c, u_xy=u_xy)
        if (r0, r1, c0, c1) == (0, inner_shape[0], 0, inner_shape[1]):
            hori = hori_c
        else:
            hori = np.full(inner_shape + (azim_num,),
                           np.float32(hori_fill))
            hori[r0:r1, c0:c1] = np.asarray(hori_c)
    if mask.min() == 0:
        m = jnp.asarray(mask[..., None] == 1)
        hori = jnp.where(m, hori, jnp.float32(hori_fill))
    hori = np.asarray(hori)
    if verbose:
        n_cells = int((mask == 1).sum())
        n_tot = mask.size
        dt = time.perf_counter() - t0
        print(f"Horizon sweep: {inner_shape[0]}x{inner_shape[1]} cells, "
              f"{azim_num} azimuths, {dt:.3f} s "
              f"(incl. compile on first call)")
        # considered-fraction printout mirrors horizon_comp.cpp:685-695
        print(f"Number of grid cells for which horizon is computed: "
              f"{n_cells} ({100.0 * n_cells / n_tot:.2f} % of the domain)")
    return hori, azim


def _tin_gridded(z, grid, vert_simp, num_vert_simp, tri_ind_simp,
                 num_tri_simp, *, offset, inner_shape, azim_num,
                 dist_search_m, hori_acc, elev_ang_low_lim, ray_org_elev):
    """Gridded horizon with a simplified outer TIN as the far field.

    The TIN (reference: built by the external ``hmm`` tool and attached to
    the Embree scene, gridded_planar_DEM_2m.py:130-265) is rasterised onto
    a coarse lattice aligned with the fine grid and swept with the
    multi-resolution engine (:mod:`horayzon_tpu.ops.multires`); the
    coarsening ratio is chosen from the TIN's triangle density and reduced
    until the fine-grid halo covers all sub-ratio marching phases.
    """
    import math

    from horayzon_tpu.ops import multires as _multires

    verts = np.asarray(vert_simp, dtype=np.float32)
    tris = np.asarray(tri_ind_simp, dtype=np.int32).reshape(-1)
    n_tri = int(min(num_tri_simp, len(tris) // 3))
    tris = tris[:3 * n_tri]

    # Coarsening ratio from the TIN's mean triangle footprint (two
    # triangles per quad of coarse cells), capped by the fine halo.
    vxy = verts.reshape(-1, 3)[:max(1, int(num_vert_simp))]
    bbox_cells = (max(np.ptp(vxy[:, 0]) / abs(grid.dx), 1.0)
                  * max(np.ptp(vxy[:, 1]) / abs(grid.dy), 1.0))
    cells_per_tri = max(bbox_cells / max(n_tri, 1), 2.0)
    ratio_log2 = int(np.clip(round(math.log2(math.sqrt(cells_per_tri
                                                       / 2.0))), 1, 8))

    step = min(abs(grid.dx), abs(grid.dy))
    rel_err = _sweep.default_rel_err(hori_acc)
    schedule = _sweep.build_schedule(step, dist_search_m, rel_err)

    def reduce_ratio(r0, shape):
        r = r0
        while r > 1:
            try:
                _multires._validate_fine_halo(schedule, r, step, offset,
                                              shape, z.shape)
                return r
            except ValueError:
                r -= 1
        _multires._validate_fine_halo(schedule, 1, step, offset, shape,
                                      z.shape)
        return 1

    # raises with the halo explanation if even ratio 1 fails
    ratio_log2 = reduce_ratio(ratio_log2, inner_shape)

    z_coarse, coarse_offset = _multires.coarse_grid_from_tin(
        verts, tris, grid=grid, fine_shape=z.shape, z_fine=z,
        ratio_log2=ratio_log2, dist_search=dist_search_m)

    return _multires.horizon_sweep_multires(
        z, z_coarse, inner_shape=inner_shape,
        azim=azimuth_angles(azim_num), ratio_log2=ratio_log2,
        coarse_offset=coarse_offset, dx=grid.dx, dy=grid.dy, offset=offset,
        dist_search=dist_search_m, hori_acc=hori_acc,
        elev_ang_low_lim=elev_ang_low_lim, ray_org_elev=ray_org_elev)


def _curved_gridded(x, y, z, vec_norm, vec_north, offset_0, offset_1, azim,
                    dist_search_m, hori_acc, elev_ang_low_lim, ray_org_elev,
                    mask=None):
    """Curved-mesh gridded horizon: planarise -> general sweep -> sample back.

    The reference builds an Embree BVH directly over the irregular ENU
    vertex cloud (horizon_comp.cpp:101-231); here the mesh is resampled to a
    regular lattice at native resolution (:mod:`horayzon_tpu.regrid`), the
    sweep runs in general (per-cell tangent frame) mode, and the horizon is
    bilinearly read back at the original inner-cell positions.
    """
    from horayzon_tpu import regrid as _regrid

    in0, in1 = vec_norm.shape[:2]
    pg = _regrid.planarize(x, y, z)
    hr, wr = pg.grid.shape

    # Positions of the original inner cells on the regular lattice
    x_in = x[offset_0:offset_0 + in0, offset_1:offset_1 + in1]
    y_in = y[offset_0:offset_0 + in0, offset_1:offset_1 + in1]
    fi_in, fj_in = pg.to_regular_indices(x_in, y_in)

    # Regular-lattice inner superset (bounding box + 1-cell margin).  With
    # a mask, only unmasked cells bound the box (the reference skips
    # masked cells per-cell, horizon_comp.cpp:749; here the sweep shrinks
    # to the unmasked bounding box and masked cells outside it read
    # clipped values that the caller overwrites with hori_fill).
    if mask is not None and (mask == 1).any():
        sel = mask == 1
        fi_b, fj_b = fi_in[sel], fj_in[sel]
    else:
        fi_b, fj_b = fi_in, fj_in
    i_lo = max(int(np.floor(fi_b.min())) - 1, 0)
    i_hi = min(int(np.ceil(fi_b.max())) + 2, hr)
    j_lo = max(int(np.floor(fj_b.min())) - 1, 0)
    j_hi = min(int(np.ceil(fj_b.max())) + 2, wr)
    rin0 = i_hi - i_lo
    rin1 = j_hi - j_lo

    # Basis vectors at the regular inner cells: interpolate the caller's
    # per-inner-cell fields through original index space.  (fi_src, fj_src)
    # of regular cells come from the planarisation's inverse mapping.
    fi_src = pg.fi[i_lo:i_hi, j_lo:j_hi] - offset_0
    fj_src = pg.fj[i_lo:i_hi, j_lo:j_hi] - offset_1
    fi_src = np.clip(fi_src, 0.0, in0 - 1.0)
    fj_src = np.clip(fj_src, 0.0, in1 - 1.0)
    norm_r = _regrid._bilinear(vec_norm.astype(np.float64), fi_src, fj_src)
    north_r = _regrid._bilinear(vec_north.astype(np.float64), fi_src,
                                fj_src)
    norm_r /= np.linalg.norm(norm_r, axis=-1, keepdims=True)
    north_r -= np.sum(north_r * norm_r, axis=-1, keepdims=True) * norm_r
    north_r /= np.linalg.norm(north_r, axis=-1, keepdims=True)
    norm_r = norm_r.astype(np.float32)
    north_r = north_r.astype(np.float32)

    geom = _terrain.basis_fields(norm_r, north_r)
    u_xy = _terrain.mean_marching_directions(azim, norm_r, north_r)

    hori_r, _ = _sweep.horizon_sweep(
        pg.z, dx=pg.grid.dx, dy=pg.grid.dy, offset=(i_lo, j_lo),
        inner_shape=(rin0, rin1), azim=azim, dist_search=dist_search_m,
        hori_acc=hori_acc, elev_ang_low_lim=elev_ang_low_lim,
        ray_org_elev=ray_org_elev, geom=geom, u_xy=u_xy)
    hori_r = np.asarray(hori_r)

    # Sample back at the original cell positions (masked cells may fall
    # outside the reduced box — clip; their values are replaced by
    # hori_fill in horizon_gridded)
    out = _regrid._bilinear(hori_r.astype(np.float64),
                            np.clip(fi_in - i_lo, 0.0, rin0 - 1.0),
                            np.clip(fj_in - j_lo, 0.0, rin1 - 1.0))
    return jnp.asarray(out.astype(np.float32))


def horizon_locations(
        vert_grid, dem_dim_0, dem_dim_1,
        coords, vec_norm, vec_north,
        dist_search,
        azim_num=360,
        hori_acc=0.25,
        ray_algorithm="binary_search",
        geom_type="grid",
        elev_ang_low_lim=-89.98,
        ray_org_elev=None,
        hori_dist_out=False):
    """Horizon computation for arbitrary locations (reference horizon.pyx:218).

    The observer elevation is found by sampling the heightfield at the
    location's (x, y) (the reference shoots a ray along +/- normal to find
    the surface, horizon_comp.cpp:944-957), lifted by ``ray_org_elev``.

    Returns ``(hori, azim)`` or ``(hori, hori_dist, azim)`` when
    ``hori_dist_out`` is True [radian / metre].
    """
    coords = np.asarray(coords, dtype=np.float32)
    vec_norm = np.asarray(vec_norm, dtype=np.float32)
    vec_north = np.asarray(vec_north, dtype=np.float32)
    if (coords.ndim != 2) or (coords.shape[1] != 3) \
            or (coords.shape[0] != vec_norm.shape[0]):
        raise ValueError("'number of dimensions and/or dimension length(s) "
                         "of 'coords' incorrect")
    if vec_norm.shape != vec_north.shape or vec_norm.ndim != 2:
        raise ValueError("dimension (lengths) of vec_norm and/or vec_north "
                         "is/are erroneous")
    if ray_algorithm not in _VALID_ALGOS:
        raise ValueError("invalid input argument for ray_algorithm")
    if hori_acc > 10.0:
        raise ValueError("limit of hori_acc (10 degree) is exceeded")
    if ray_org_elev is None:
        ray_org_elev = np.array([0.01], dtype=np.float32)
    ray_org_elev = np.atleast_1d(np.asarray(ray_org_elev, dtype=np.float32))
    num_loc = coords.shape[0]
    if len(ray_org_elev) not in (1, num_loc):
        raise ValueError("length of array 'ray_org_elev' must be either one "
                         "or correspond to the number of locations")
    if ray_org_elev.min() < 0.005:
        raise TypeError("minimal allowed value for 'ray_org_elev' is 0.005 m")
    if len(ray_org_elev) == 1:
        ray_org_elev = np.repeat(ray_org_elev, num_loc)

    x, y, z = _terrain.decompose_vert_grid(vert_grid, dem_dim_0, dem_dim_1)
    grid = _terrain.detect_regular_grid(x, y)
    if grid is None:
        # Curved ENU mesh: planarise; the per-location sweep measures angles
        # in each location's own tangent frame, so it runs unchanged on the
        # resampled lattice (locations keep their exact ENU coordinates).
        from horayzon_tpu import regrid as _regrid
        pg = _regrid.planarize(x, y, z)
        grid = pg.grid
        z = pg.z

    from horayzon_tpu.ops import locations as _locations
    azim = azimuth_angles(azim_num)
    hori, hori_dist = _locations.horizon_locations_sweep(
        z, grid, coords, vec_norm, vec_north, azim,
        dist_search * 1000.0, hori_acc, elev_ang_low_lim,
        ray_org_elev)
    if hori_dist_out:
        return np.asarray(hori), np.asarray(hori_dist), azim
    return np.asarray(hori), azim

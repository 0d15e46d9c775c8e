# Copyright (c) 2026
# MIT License
"""Shadow maps and shortwave-radiation correction factors.

Equivalent of reference ``horayzon/shadow.pyx`` + ``shadow_comp.cpp``: a
:class:`Terrain` object is initialised once with the DEM and per-cell vectors
(the reference builds the Embree BVH once, shadow_comp.cpp:318-380) and then
queried per sun position.

Differences from the reference:

* The per-cell occlusion ray toward the sun (shadow_comp.cpp:454-467) becomes
  one shifted-slice sweep along the sun's horizontal direction
  (:func:`horayzon_tpu.ops.sweep.shadow_metric`).
* Curved-Earth (irregular ENU) meshes are planarised onto a regular lattice
  (:mod:`horayzon_tpu.regrid`); the occlusion test runs on the lattice and is
  sampled back (nearest) to the original cells, while the per-cell
  illumination formulas (self-shadowing, refraction, Mueller-Scherer factor)
  are evaluated *exactly* at the original cell positions.
* Sun positions batch along a leading time axis (``shadow_batch`` /
  ``sw_dir_cor_batch``) — the reference iterates time steps in Python
  (e.g. examples/shadow/gridded_curved_DEM_SRTM.py:190-266).
* The terrain data live in device memory; there is no keep-alive contract on
  caller arrays (the reference stores raw NumPy pointers,
  shadow_comp.cpp:332-346).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from horayzon_tpu import terrain as _terrain
from horayzon_tpu.ops import refraction as _refraction
from horayzon_tpu.ops import sweep as _sweep

_RAY_ORG_ELEV = 0.05  # hard-coded lift of the ray origin [m]
                      # (shadow_comp.cpp:388,497)


@functools.partial(
    jax.jit,
    static_argnames=("sched_meta", "pads", "offset", "comp_shape",
                     "refrac_cor", "mode", "ang_max", "curved", "engine",
                     "scan_meta"))
def _sun_step(z_outer, fields, sun_position, *, sched_meta, pads, offset,
              comp_shape, refrac_cor, mode, ang_max, curved,
              engine="sweep", scan_meta=None):
    """One sun position -> shadow mask (mode='shadow') or correction factor
    (mode='sw_dir_cor').  Mirrors CppTerrain::shadow / ::sw_dir_cor
    (shadow_comp.cpp:386-605).

    ``comp_shape`` is the occlusion-lattice inner shape; for curved meshes
    the classification runs on the original cells via the nearest-neighbour
    back-map ``fields["bi"], fields["bj"]``.
    """
    # ---- Occlusion sweep on the (regular) compute lattice ----------------
    xr = fields["xr"]              # (c0, c1) lattice x of compute cells
    yr = fields["yr"]
    z_org_r = fields["z_org_r"]    # lattice terrain + lift
    dxdy = fields["dxdy"]          # (2,) = (dx, dy) of the lattice

    sxr = sun_position[0] - xr
    syr = sun_position[1] - yr
    szr = sun_position[2] - z_org_r
    mag_r = jnp.sqrt(sxr * sxr + syr * syr + szr * szr)

    cx = fields["center"][0]
    cy = fields["center"][1]
    kx = sun_position[0] - cx
    ky = sun_position[1] - cy
    k_norm = jnp.sqrt(kx * kx + ky * ky)
    near_vertical = k_norm < 1.0e-6
    kx_u = jnp.where(near_vertical, 1.0, kx / jnp.maximum(k_norm, 1e-6))
    ky_u = jnp.where(near_vertical, 0.0, ky / jnp.maximum(k_norm, 1e-6))
    u_cells = jnp.stack([ky_u / dxdy[1], kx_u / dxdy[0]])  # (ui, uj)

    adv = (sxr * kx_u + syr * ky_u) / mag_r
    m_slope = (szr / mag_r) / jnp.maximum(adv, 1.0e-4)

    if engine == "scan":
        # Log-doubling suffix-max scan (ops/shadow_scan.py): O(log N)
        # whole-grid passes with the domain-mean ray slope.
        from horayzon_tpu.ops import shadow_scan as _scan
        num_doublings, pad, step = scan_meta
        cz = fields["center"][2]
        m_mean = (sun_position[2] - cz) / jnp.maximum(k_norm, 1e-6)
        metric = _scan._shadow_scan_core(
            z_outer, z_org_r, m_mean, u_cells, step,
            num_doublings=num_doublings, pad=pad, offset=offset,
            inner_shape=comp_shape)
    else:
        metric = _sweep._shadow_metric_core(
            z_outer, z_org_r, fields["z_inner_r"], m_slope, u_cells,
            fields["s_phases"],
            sched_meta=sched_meta, pads=pads, offset=offset,
            inner_shape=comp_shape)
    occluded = jnp.logical_and(metric > 0.0, jnp.logical_not(near_vertical))
    return _classify_one(fields, sun_position, occluded,
                         refrac_cor=refrac_cor, mode=mode, ang_max=ang_max,
                         curved=curved)


def _classify_one(fields, sun_position, occluded, *, refrac_cor, mode,
                  ang_max, curved, metric=None, soft_tau=None,
                  straight_through=True):
    """Per-cell illumination classification given the occlusion result
    (shadow_comp.cpp:449-484 / :561-596).

    ``metric``/``soft_tau``: optional soft occlusion for ``sw_dir_cor``
    (SURVEY.md section 7 step 8) — the hard step ``metric > 0`` has zero
    gradient w.r.t. elevation almost everywhere, so the soft path uses
    ``sigmoid(metric / soft_tau)`` (``metric`` is the signed clearance
    maximum in metres).  With ``straight_through`` the forward value stays
    the HARD result bit-for-bit and only the backward uses the sigmoid."""
    if curved:
        occluded = occluded[fields["bi"], fields["bj"]]
        if metric is not None:
            metric = metric[fields["bi"], fields["bj"]]

    # ---- Per-cell classification at the original cells -------------------
    x_in = fields["x_in"]
    y_in = fields["y_in"]
    z_org = fields["z_org"]
    norm = fields["norm"]          # (in0, in1, 3)
    tilt = fields["tilt"]
    mask = fields["mask"]          # bool

    sx = sun_position[0] - x_in
    sy = sun_position[1] - y_in
    sz = sun_position[2] - z_org
    mag = jnp.sqrt(sx * sx + sy * sy + sz * sz)
    sun = jnp.stack([sx / mag, sy / mag, sz / mag], axis=-1)
    if refrac_cor:
        sun = _refraction.refract_sun_vector(sun, norm, fields["elevation"])
    dot_ns = jnp.sum(norm * sun, axis=-1)
    dot_ts = jnp.sum(tilt * sun, axis=-1)

    if mode == "shadow":
        # Encoding 0 illuminated / 1 self-shaded / 2 terrain-shaded /
        # 3 masked (shadow_comp.cpp:449-484)
        out = jnp.where(dot_ts > 0.0,
                        jnp.where(occluded, jnp.uint8(2), jnp.uint8(0)),
                        jnp.uint8(1))
        return jnp.where(mask, out, jnp.uint8(3))
    else:
        # Mueller & Scherer (2005) factor (shadow_comp.cpp:561-596)
        dot_min = jnp.float32(math.cos(math.radians(ang_max)))
        val = (dot_ts / jnp.maximum(dot_ns, dot_min)) * fields["surf_enl_fac"]
        if metric is not None and soft_tau is not None:
            occ_soft = jax.nn.sigmoid(metric / jnp.float32(soft_tau))
            if straight_through:
                occ_eff = occ_soft + jax.lax.stop_gradient(
                    jnp.where(occluded, 1.0, 0.0) - occ_soft)
            else:
                occ_eff = occ_soft
            val = val * (1.0 - occ_eff)
        else:
            val = jnp.where(occluded, 0.0, val)
        out = jnp.where(dot_ts > dot_min, val, 0.0)
        return jnp.where(mask, out, fields["sw_dir_cor_fill"])


@functools.partial(
    jax.jit,
    static_argnames=("sched_meta", "pads", "offset", "comp_shape",
                     "refrac_cor", "ang_max", "curved", "soft_tau",
                     "straight_through"))
def _soft_sun_step(z_outer, fields, sun_position, *, sched_meta, pads,
                   offset, comp_shape, refrac_cor, ang_max, curved,
                   soft_tau, straight_through):
    """Differentiable sw_dir_cor for one sun position (XLA sweep engine).

    Rebuilds the lattice ray-origin fields from the traced ``z_outer`` so
    gradients w.r.t. elevation flow through the occlusion metric, the sun
    unit vector and (on regular grids) the classification heights; the
    hard occlusion step is softened per :func:`_classify_one`."""
    z_inner_r = jax.lax.dynamic_slice(z_outer, offset, comp_shape)
    z_org_r = z_inner_r + _RAY_ORG_ELEV * fields["norm_r_z"]
    xr = fields["xr"]
    yr = fields["yr"]
    dxdy = fields["dxdy"]

    sxr = sun_position[0] - xr
    syr = sun_position[1] - yr
    szr = sun_position[2] - z_org_r
    mag_r = jnp.sqrt(sxr * sxr + syr * syr + szr * szr)
    cx = fields["center"][0]
    cy = fields["center"][1]
    kx = sun_position[0] - cx
    ky = sun_position[1] - cy
    k_norm = jnp.sqrt(kx * kx + ky * ky)
    near_vertical = k_norm < 1.0e-6
    kx_u = jnp.where(near_vertical, 1.0, kx / jnp.maximum(k_norm, 1e-6))
    ky_u = jnp.where(near_vertical, 0.0, ky / jnp.maximum(k_norm, 1e-6))
    u_cells = jnp.stack([ky_u / dxdy[1], kx_u / dxdy[0]])
    adv = (sxr * kx_u + syr * ky_u) / mag_r
    m_slope = (szr / mag_r) / jnp.maximum(adv, 1.0e-4)
    metric = _sweep._shadow_metric_core(
        z_outer, z_org_r, z_inner_r, m_slope, u_cells,
        fields["s_phases"], sched_meta=sched_meta, pads=pads,
        offset=offset, inner_shape=comp_shape)
    occluded = jnp.logical_and(metric > 0.0,
                               jnp.logical_not(near_vertical))
    metric = jnp.where(near_vertical, jnp.float32(-1.0e30), metric)
    if not curved:
        # regular grid: the classification heights are the lattice
        # heights — recompute from the traced elevation
        fields = dict(fields, z_org=z_org_r)
    return _classify_one(fields, sun_position, occluded,
                         refrac_cor=refrac_cor, mode="sw_dir_cor",
                         ang_max=ang_max, curved=curved, metric=metric,
                         soft_tau=soft_tau,
                         straight_through=straight_through)


class Terrain:
    """Initialise-once / query-many terrain shadow engine.

    Mirrors the reference Terrain cdef class (shadow.pyx:17-199)."""

    def __init__(self):
        self._initialised = False

    def initialise(self, vert_grid, dem_dim_0, dem_dim_1,
                   offset_0, offset_1,
                   vec_tilt, vec_norm,
                   surf_enl_fac, elevation, mask,
                   geom_type="grid",
                   sw_dir_cor_fill=np.nan,
                   ang_max=89.0,
                   refrac_cor=False,
                   acc=0.25,
                   engine="sweep"):
        """Load DEM data and build the device-resident terrain state.

        Signature mirrors shadow.pyx:27-147 (``acc`` is the accuracy knob
        driving the sweep sample density; ``engine`` selects the occlusion
        computation: "sweep" = marching sweep with per-cell ray slopes,
        "scan" = log-doubling suffix-max scan with the domain-mean ray
        slope, ops/shadow_scan.py)."""
        if engine not in ("sweep", "scan"):
            raise ValueError("engine must be 'sweep' or 'scan'")
        self.engine = engine
        vec_tilt = np.asarray(vec_tilt, dtype=np.float32)
        vec_norm = np.asarray(vec_norm, dtype=np.float32)
        surf_enl_fac = np.asarray(surf_enl_fac, dtype=np.float32)
        elevation = np.asarray(elevation, dtype=np.float32)
        mask = np.asarray(mask)
        # --- Validation (mirrors shadow.pyx:86-133) -----------------------
        if ((offset_0 + vec_tilt.shape[0] > dem_dim_0)
                or (offset_1 + vec_tilt.shape[1] > dem_dim_1)):
            raise ValueError("inconsistency between input arguments "
                             "'dem_dim_0', 'dem_dim_1', 'offset_0', "
                             "'offset_1' and 'vec_norm'")
        if ((vec_tilt.ndim != 3) or (vec_norm.ndim != 3)
                or (vec_tilt.shape[2] != 3)
                or (vec_tilt.shape != vec_norm.shape)):
            raise ValueError("Inconsistent/incorrect shape of 'vec_tilt' "
                             "and/or 'vec_norm'")
        shp = vec_tilt.shape[:2]
        if (surf_enl_fac.shape != shp or elevation.shape != shp
                or mask.shape != shp):
            raise ValueError("Inconsistent/incorrect shape of "
                             "'surf_enl_fac', 'elevation' and/or 'mask'")
        if ((np.abs((vec_tilt ** 2).sum(axis=2) - 1.0).max() > 1.0e-5)
                or (np.abs((vec_norm ** 2).sum(axis=2) - 1.0).max()
                    > 1.0e-5)):
            raise ValueError("Vectors in 'vec_tilt' and/or 'vec_norm' are "
                             "not normalised")
        if geom_type not in ("triangle", "quad", "grid"):
            raise ValueError("invalid input argument for geom_type")
        if mask.dtype != np.uint8:
            raise TypeError("data type of mask must be 'uint8'")
        if (ang_max < 85.0) or (ang_max > 89.99):
            raise TypeError("'ang_max' must be in the range [85.0, 89.99]")

        x, y, z = _terrain.decompose_vert_grid(vert_grid, dem_dim_0,
                                               dem_dim_1)
        in0, in1 = shp
        self.inner_shape = (in0, in1)
        self.ang_max = float(ang_max)
        self.refrac_cor = bool(refrac_cor)

        sl_in = (slice(offset_0, offset_0 + in0),
                 slice(offset_1, offset_1 + in1))
        x_in = x[sl_in].astype(np.float32)
        y_in = y[sl_in].astype(np.float32)
        z_in = z[sl_in].astype(np.float32)
        z_org = z_in + _RAY_ORG_ELEV * vec_norm[..., 2]

        grid = _terrain.detect_regular_grid(x, y)
        self._curved = grid is None
        if not self._curved:
            z_comp = z.astype(np.float32)
            comp_grid = grid
            comp_offset = (int(offset_0), int(offset_1))
            comp_shape = (in0, in1)
            z_org_r = z_org
            xr, yr = x_in, y_in
            back = None
            dem_h, dem_w = dem_dim_0, dem_dim_1
        else:
            from horayzon_tpu import regrid as _regrid
            pg = _regrid.planarize(x, y, z)
            comp_grid = pg.grid
            z_comp = pg.z
            dem_h, dem_w = pg.grid.shape
            fi_in, fj_in = pg.to_regular_indices(x_in, y_in)
            i_lo = max(int(np.floor(fi_in.min())) - 1, 0)
            i_hi = min(int(np.ceil(fi_in.max())) + 2, dem_h)
            j_lo = max(int(np.floor(fj_in.min())) - 1, 0)
            j_hi = min(int(np.ceil(fj_in.max())) + 2, dem_w)
            comp_offset = (i_lo, j_lo)
            comp_shape = (i_hi - i_lo, j_hi - j_lo)
            # Lattice-cell quantities for the occlusion test
            fi_src = np.clip(pg.fi[i_lo:i_hi, j_lo:j_hi] - offset_0,
                             0.0, in0 - 1.0)
            fj_src = np.clip(pg.fj[i_lo:i_hi, j_lo:j_hi] - offset_1,
                             0.0, in1 - 1.0)
            norm_r = _regrid._bilinear(vec_norm.astype(np.float64),
                                       fi_src, fj_src)
            norm_r /= np.linalg.norm(norm_r, axis=-1, keepdims=True)
            xr1 = comp_grid.x0 + np.arange(j_lo, j_hi) * comp_grid.dx
            yr1 = comp_grid.y0 + np.arange(i_lo, i_hi) * comp_grid.dy
            xr = np.broadcast_to(xr1[None, :], comp_shape) \
                .astype(np.float32)
            yr = np.broadcast_to(yr1[:, None], comp_shape) \
                .astype(np.float32)
            z_inner_r = z_comp[i_lo:i_hi, j_lo:j_hi]
            z_org_r = (z_inner_r
                       + _RAY_ORG_ELEV * norm_r[..., 2]).astype(np.float32)
            bi = np.clip(np.rint(fi_in - i_lo).astype(np.int32), 0,
                         comp_shape[0] - 1)
            bj = np.clip(np.rint(fj_in - j_lo).astype(np.int32), 0,
                         comp_shape[1] - 1)
            back = (bi, bj)

        self.grid = comp_grid
        self.offset = comp_offset
        self.comp_shape = comp_shape

        # Shadow rays run to the domain edge (tfar = inf in the reference,
        # shadow_comp.cpp:462) -> schedule over the lattice diagonal.
        diag = math.hypot(dem_w * abs(comp_grid.dx),
                          dem_h * abs(comp_grid.dy))
        step = min(abs(comp_grid.dx), abs(comp_grid.dy))
        rel_err = _sweep.default_rel_err(acc)
        self.schedule = _sweep.build_schedule(step, diag, rel_err)

        step_m = min(abs(comp_grid.dx), abs(comp_grid.dy))
        k_cells = max(1, int(math.ceil(diag / step_m)))
        self.scan_meta = (max(0, int(math.ceil(math.log2(k_cells)))),
                          k_cells + 2, float(step_m))

        x_axis = comp_grid.x_axis()
        y_axis = comp_grid.y_axis()
        cx = 0.5 * (x_axis[0] + x_axis[-1])
        cy = 0.5 * (y_axis[0] + y_axis[-1])
        cz = float(np.mean(z_org_r))

        self._z_outer = jnp.asarray(z_comp, dtype=jnp.float32)
        norm_r_z = (vec_norm[..., 2] if not self._curved
                    else norm_r[..., 2])
        fields = {
            "x_in": jnp.asarray(x_in),
            "y_in": jnp.asarray(y_in),
            "norm_r_z": jnp.asarray(norm_r_z, dtype=jnp.float32),
            "z_org": jnp.asarray(z_org, dtype=jnp.float32),
            "xr": jnp.asarray(xr, dtype=jnp.float32),
            "yr": jnp.asarray(yr, dtype=jnp.float32),
            "z_org_r": jnp.asarray(z_org_r, dtype=jnp.float32),
            "z_inner_r": jnp.asarray(
                z_in if not self._curved else z_inner_r,
                dtype=jnp.float32),
            "norm": jnp.asarray(vec_norm),
            "tilt": jnp.asarray(vec_tilt),
            "surf_enl_fac": jnp.asarray(surf_enl_fac),
            "elevation": jnp.asarray(elevation),
            "mask": jnp.asarray(mask == 1),
            "sw_dir_cor_fill": jnp.float32(sw_dir_cor_fill),
            "center": jnp.asarray([cx, cy, cz], dtype=jnp.float32),
            "dxdy": jnp.asarray([comp_grid.dx, comp_grid.dy],
                                dtype=jnp.float32),
            "s_phases": tuple(
                jnp.asarray(_sweep._pad_unroll(s[None, :],
                                               _sweep.UNROLL)[0])
                for s in self.schedule.s_values),
        }
        if back is not None:
            fields["bi"] = jnp.asarray(back[0])
            fields["bj"] = jnp.asarray(back[1])
        self._fields = fields
        self._initialised = True
        num_gc = int((mask == 1).sum())
        print(f"Considered grid cells (number): {num_gc}")
        if refrac_cor:
            print("Account for atmospheric refraction")

    # ------------------------------------------------------------------
    def _check(self, sun_position):
        if not self._initialised:
            raise RuntimeError("Terrain not initialised")
        sun_position = np.asarray(sun_position, dtype=np.float32)
        if sun_position.ndim == 1:
            if sun_position.size != 3:
                raise ValueError("array 'sun_position' has incorrect shape")
        elif sun_position.ndim != 2 or sun_position.shape[1] != 3:
            raise ValueError("array 'sun_position' has incorrect shape")
        return sun_position

    def _run(self, sun_position, mode):
        sun_position = self._check(sun_position)
        kwargs = dict(sched_meta=self.schedule.meta(),
                      pads=self.schedule.pads,
                      offset=self.offset,
                      comp_shape=self.comp_shape,
                      refrac_cor=self.refrac_cor,
                      mode=mode, ang_max=self.ang_max,
                      curved=self._curved,
                      engine=self.engine,
                      scan_meta=self.scan_meta)
        if sun_position.ndim == 1:
            return _sun_step(self._z_outer, self._fields,
                             jnp.asarray(sun_position), **kwargs)
        step = functools.partial(_sun_step, **kwargs)
        return jax.lax.map(
            lambda sp: step(self._z_outer, self._fields, sp),
            jnp.asarray(sun_position))

    # ------------------------------------------------------------------
    def shadow(self, sun_position, shadow_buffer=None):
        """Shadow mask for one sun position (shadow.pyx:149-170).

        0: illuminated, 1: self-shaded, 2: terrain-shaded, 3: masked."""
        out = np.asarray(self._run(sun_position, "shadow"))
        if shadow_buffer is not None:
            shadow_buffer[:] = out
        return out

    def sw_dir_cor(self, sun_position, sw_dir_cor_buffer=None):
        """Shortwave correction factor for one sun position
        (shadow.pyx:172-199; Mueller & Scherer 2005)."""
        out = np.asarray(self._run(sun_position, "sw_dir_cor"))
        if sw_dir_cor_buffer is not None:
            sw_dir_cor_buffer[:] = out
        return out

    def shadow_batch(self, sun_positions):
        """Shadow masks for a (T, 3) sun track in one device call."""
        return np.asarray(self._run(sun_positions, "shadow"))

    def sw_dir_cor_batch(self, sun_positions):
        """Correction factors for a (T, 3) sun track in one device call."""
        return np.asarray(self._run(sun_positions, "sw_dir_cor"))

    def sw_dir_cor_soft(self, sun_position, elevation=None, soft_tau=1.0,
                        straight_through=True):
        """Differentiable shortwave correction factor (soft occlusion).

        The hard terrain-occlusion step (shadow_comp.cpp:563-576) has zero
        gradient w.r.t. elevation almost everywhere; this entry softens it
        to ``sigmoid(clearance / soft_tau)`` (``soft_tau`` in metres of
        signed clearance) per SURVEY.md section 7 step 8.  With
        ``straight_through`` (default) the forward VALUES equal the hard
        :meth:`sw_dir_cor` result and only the backward uses the sigmoid;
        ``straight_through=False`` gives the fully soft value (use for
        finite-difference checks).  The metric always comes from the
        marching sweep, one sun position at a time.

        ``elevation``: optional outer compute-lattice heightfield to
        differentiate through (defaults to the stored terrain).  Returns
        a jnp array (keep it traced to take grads).  On curved meshes the
        per-cell classification fields stay at their initialise() values;
        gradients flow through the occlusion metric and sun geometry.
        """
        sun_position = self._check(sun_position)
        z = (self._z_outer if elevation is None
             else jnp.asarray(elevation, dtype=jnp.float32))
        kw = dict(sched_meta=self.schedule.meta(),
                  pads=self.schedule.pads, offset=self.offset,
                  comp_shape=self.comp_shape,
                  refrac_cor=self.refrac_cor, ang_max=self.ang_max,
                  curved=self._curved, soft_tau=float(soft_tau),
                  straight_through=bool(straight_through))
        if sun_position.ndim == 1:
            return _soft_sun_step(z, self._fields,
                                  jnp.asarray(sun_position), **kw)
        step = functools.partial(_soft_sun_step, **kw)
        return jax.lax.map(
            lambda sp: step(z, self._fields, sp),
            jnp.asarray(sun_position))

# Copyright (c) 2026
# MIT License
"""Gather-free horizon / shadow sweeps over a regular heightfield.

This module replaces the reference's ray-tracing
core (Embree BVH traversal driven by per-ray elevation searches,
horizon_comp.cpp:241-498 and shadow_comp.cpp:386-605).

Key idea
--------
On a regular grid, the sample position at ground distance ``s`` along a fixed
azimuth is the *same shift* for every grid cell.  So instead of casting rays
per cell, we march distance samples and read a *shifted view* of the entire
(outer) heightfield — four aligned slices blended bilinearly — and update a
running maximum of the elevation-angle ratio per cell.  Every operation is a
dense element-wise op; there are no gathers and no divergent loops.

Accuracy model
--------------
* Near/mid field (mip level 0): along a straight ground track the bilinear
  surface is piecewise *quadratic* in the arc length.  Each marching step
  reads one endpoint sample; the parabola through the last *three*
  consecutive samples is maximised analytically over the trailing
  two-segment window (the stationary point of ``(h(t) - z0)/(s + t)``
  solves a scalar quadratic).  This resolves the strong angular sensitivity
  at small distances that pure point sampling misses, at one heightfield
  read per step.
* Far field: a conservative max-mip pyramid (:mod:`.mip`) with
  distance-proportional steps; the angular error is bounded by
  ``footprint / distance * slope``, controlled by the ``hori_acc`` knob
  (the reference quantises elevation to ``hori_acc / 5`` steps,
  horizon_comp.cpp:721-731).

Performance notes
-----------------
The marching loops are ``lax.scan``s unrolled by :data:`UNROLL` steps per
iteration so the running-maximum carries round-trip device memory once per
``UNROLL`` samples instead of once per sample (the dominant traffic
otherwise).

Geometry modes
--------------
* *planar* — surface normal is the global +z axis everywhere (reference
  examples with ``vec_norm=(0,0,1)``); ratio = ``(h - z0) / s``.
* *general* — per-cell orthonormal basis (east, north, norm), e.g. a curved
  Earth ENU grid planarised by :mod:`horayzon_tpu.regrid`.  The ratio is
  measured in each cell's local tangent frame while the march follows the
  domain-mean azimuth direction (the per-cell azimuth-plane deviation is far
  below the azimuth bin width).

The whole sweep is differentiable w.r.t. the heightfield (gradients flow
through the bilinear blends, max-pools and running maxima).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from horayzon_tpu.ops import mip

_NEG_INIT = -3.0e38
_DEN_EPS = 1.0e-6

#: scan-unroll factor (samples per scan iteration)
UNROLL = 8


# ---------------------------------------------------------------------------
# Sample schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Phase:
    """One constant-mip-level marching phase.

    kind: 'd2' — level-0 near field, two reads per step (midpoint +
          endpoint; per-interval exact parabola);
          'd1' — level-0, one read per step (trailing-window parabola);
          'mip' — coarse-level point samples.
    """
    level: int          # mip level
    pad: int            # padding (in level cells) applied to this level
    num: int            # number of samples
    kind: str = "mip"
    #: True when every sample of the phase provably stays inside the real
    #: heightfield for all inner cells (halo wide enough) — the per-sample
    #: in-domain masks can then be skipped.
    safe: bool = False

    def key(self):
        return (self.kind, self.level, self.pad, self.num, self.safe)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Distance-sample schedule shared by all azimuths."""
    phases: tuple               # tuple of Phase
    s_values: tuple             # tuple of np.ndarray (one per phase) [metre]
    step: float                 # base step [metre]
    dist: float                 # search distance [metre]

    @property
    def num_levels(self):
        return max(p.level for p in self.phases) + 1

    @property
    def pads(self):
        pads = [0] * self.num_levels
        for p in self.phases:
            pads[p.level] = max(pads[p.level], p.pad)
        return tuple(pads)

    @property
    def num_samples(self):
        return sum(2 * p.num if p.kind == "d2" else p.num
                   for p in self.phases)

    def meta(self):
        """Hashable static description."""
        return tuple(p.key() for p in self.phases)


def build_schedule(step, dist_search, rel_err, max_level=10, near_exact=16):
    """Build the marching schedule.

    Parameters
    ----------
    step : float
        Base sample spacing = finest grid spacing [metre].
    dist_search : float
        Horizon search distance [metre].
    rel_err : float
        Far-field relative-footprint error budget: the dense (exact) phase
        runs to ``step / rel_err``, after which each phase doubles the step
        and the mip level.
    max_level : int
        Maximum mip level to use.
    near_exact : int
        Number of leading dense steps evaluated with two reads per step
        (per-interval exact parabolas) — the strongly angle-sensitive near
        field; the remaining dense steps use one read per step.
    """
    if dist_search <= 0.0:
        raise ValueError("dist_search must be positive")
    rel_err = float(np.clip(rel_err, 1.0e-4, 0.2))
    n_dense = int(math.ceil(1.0 / rel_err))

    phases = []
    s_arrays = []
    # Dense phases at native resolution: sample points step, 2*step, ...
    n0 = min(n_dense, int(math.ceil(dist_search / step)))
    s = np.arange(1, n0 + 1, dtype=np.float64) * step
    s_end = float(s[-1])
    pad0 = int(math.ceil(s_end / step)) + 2
    n2 = min(near_exact, n0)
    phases.append(Phase(level=0, pad=pad0, num=n2, kind="d2"))
    s_arrays.append(s[:n2].astype(np.float32))
    if n0 > n2:
        phases.append(Phase(level=0, pad=pad0, num=n0 - n2, kind="d1"))
        s_arrays.append(s[n2:].astype(np.float32))

    level = 1
    while s_end < dist_search - 1.0e-6:
        lvl = min(level, max_level)
        step_l = step * (2 ** level)
        if lvl == max_level or level >= 60:
            s_cap = dist_search
        else:
            s_cap = min(dist_search, n_dense * step_l)
        s = np.arange(s_end + step_l, s_cap + 0.5 * step_l, step_l,
                      dtype=np.float64)
        if len(s) == 0:
            s = np.array([s_cap], dtype=np.float64)
        s = np.minimum(s, dist_search)
        s_end = float(s[-1])
        pad = int(math.ceil(s_end / (step * 2 ** lvl))) + 2
        phases.append(Phase(level=lvl, pad=pad, num=len(s), kind="mip"))
        s_arrays.append(s.astype(np.float32))
        if lvl == max_level:
            break
        level += 1

    return Schedule(phases=tuple(phases), s_values=tuple(s_arrays),
                    step=float(step), dist=float(dist_search))


def default_rel_err(hori_acc_deg):
    """Far-field error budget matching the reference ``hori_acc`` contract."""
    return math.tan(math.radians(max(hori_acc_deg, 0.02)))


def mark_safe_phases(schedule, halo_cells):
    """Split/flag dense phases whose samples provably stay inside the grid.

    ``halo_cells``: minimum distance (in cells) from any inner cell to the
    outer-grid edge.  Samples with ``s/step + 2 <= halo_cells`` cannot read
    outside the real heightfield for any inner cell, so their in-domain
    masks are skipped (``Phase.safe``).  Dense phases straddling the
    boundary are split in two.
    """
    s_safe = (halo_cells - 2) * schedule.step
    phases = []
    s_arrays = []
    for ph, s in zip(schedule.phases, schedule.s_values):
        if ph.kind not in ("d1", "d2"):
            phases.append(ph)
            s_arrays.append(s)
            continue
        n_safe = int(np.searchsorted(s, s_safe, side="right"))
        # Interior dense-phase boundaries must fall on UNROLL multiples:
        # the scan tables pad trailing samples by duplication, which would
        # otherwise corrupt the parabola history entering the next phase.
        n_safe = (n_safe // UNROLL) * UNROLL
        if n_safe == len(s):
            phases.append(dataclasses.replace(ph, safe=True))
            s_arrays.append(s)
        elif n_safe == 0:
            phases.append(ph)
            s_arrays.append(s)
        else:
            phases.append(dataclasses.replace(ph, num=n_safe, safe=True))
            s_arrays.append(s[:n_safe])
            phases.append(dataclasses.replace(ph, num=len(s) - n_safe))
            s_arrays.append(s[n_safe:])
    return Schedule(phases=tuple(phases), s_values=tuple(s_arrays),
                    step=schedule.step, dist=schedule.dist)


# ---------------------------------------------------------------------------
# Shifted reads
# ---------------------------------------------------------------------------

def _read_dense(zp, i0, j0, fi, fj, inner_shape):
    """Bilinear read of the level-0 heightfield shifted by a fractional
    offset (replaces per-ray rtcOccluded1 BVH traversal,
    horizon_comp.cpp:241-262).  Four static slices of the shifted window,
    blended elementwise: no matrix unit, so no reduced-precision products."""
    in0, in1 = inner_shape
    win = lax.dynamic_slice(zp, (i0, j0), (in0 + 1, in1 + 1))
    top = (1.0 - fj) * win[:-1, :-1] + fj * win[:-1, 1:]
    bot = (1.0 - fj) * win[1:, :-1] + fj * win[1:, 1:]
    return (1.0 - fi) * top + fi * bot


def _mip_slice_size(n, level):
    return (n + 2 ** level - 2) // (2 ** level) + 1


def _read_mip(zp, level, base_i, base_j, r_i, r_j, inner_shape):
    """Nearest read of mip level ``level`` upsampled to inner resolution.

    ``base`` is the padded-level slice start, ``r`` the sub-level alignment
    remainder (both may be traced)."""
    in0, in1 = inner_shape
    k = 2 ** level
    si = _mip_slice_size(in0, level)
    sj = _mip_slice_size(in1, level)
    win = lax.dynamic_slice(zp, (base_i, base_j), (si, sj))
    up = jnp.repeat(jnp.repeat(win, k, axis=0), k, axis=1)
    return lax.dynamic_slice(up, (r_i, r_j), (in0, in1))


def _inside_mask(i0, j0, fi, fj, pad0, inner_shape, outer_shape):
    """Per-cell mask: bilinear read lies fully inside the real heightfield.

    ``i0``/``j0`` are padded slice starts (include offset+pad+floor(shift)),
    ``fi``/``fj`` the fractional parts.  A read whose 4-corner stencil
    touches the sentinel padding yields a blend of real terrain and the pad
    value; such reads are conservative for the running maximum but must not
    feed the quadratic segment fit (they would fabricate phantom peaks)."""
    in0, in1 = inner_shape
    h, w = outer_shape
    pos_i0 = i0 - pad0  # global floor row of cell 0's read
    pos_j0 = j0 - pad0
    ri = jnp.arange(in0, dtype=jnp.int32).reshape(in0, 1)
    cj = jnp.arange(in1, dtype=jnp.int32).reshape(1, in1)
    top = ri + pos_i0
    left = cj + pos_j0
    ok_i = (top >= 0) & (top + 1 <= h - 1)
    ok_j = (left >= 0) & (left + 1 <= w - 1)
    return ok_i & ok_j


def _segment_quad_coeffs(h0, hm, h1, length):
    """Quadratic h(t) = a t^2 + b t + h0 through three equally spaced
    samples at t = 0, length/2, length."""
    inv_l = 1.0 / length
    a = (2.0 * h1 + 2.0 * h0 - 4.0 * hm) * inv_l * inv_l
    b = (4.0 * hm - 3.0 * h0 - h1) * inv_l
    return a, b


def _segment_interior_t(a, b, h0, z0, s_start, length, t_lo=0.0):
    """Interior stationary point of (h(t) - z0)/(s_start + t) on
    (t_lo, length).

    Solves a t^2 + 2 a s t + (b s - h0 + z0) = 0 for t; returns (t, valid).
    """
    rad = s_start * s_start - (b * s_start - h0 + z0) / jnp.where(
        jnp.abs(a) > 1e-12, a, jnp.float32(1e-12))
    # Double-where: sanitise before sqrt so the untaken branch cannot inject
    # inf/NaN into gradients (d sqrt(0) = inf).
    pos = rad > 0.0
    safe_rad = jnp.where(pos, rad, 1.0)
    t = -s_start + jnp.sqrt(safe_rad)
    valid = (jnp.abs(a) > 1e-12) & pos & (t > t_lo + 1e-3) \
        & (t < length - 1e-3)
    return jnp.clip(t, 0.0, length), valid


# ---------------------------------------------------------------------------
# Host-side shift precomputation (horizon: static azimuths)
# ---------------------------------------------------------------------------

def _pad_unroll(arr, unroll):
    """Pad the sample axis (last) to a multiple of ``unroll`` by repeating
    the final sample (duplicate max-updates are no-ops), then fold it into
    (..., M/unroll, unroll)."""
    m = arr.shape[-1]
    m_pad = ((m + unroll - 1) // unroll) * unroll
    if m_pad != m:
        last = arr[..., -1:]
        arr = np.concatenate([arr] + [last] * (m_pad - m), axis=-1)
    return arr.reshape(arr.shape[:-1] + (m_pad // unroll, unroll))


def horizon_shift_tables(schedule, azim, dx, dy, offset, u_xy=None,
                         unroll=UNROLL):
    """Per-(azimuth, sample) shift tables as numpy arrays.

    Parameters
    ----------
    schedule : Schedule
    azim : (A,) array of azimuth angles [radian], clockwise from North.
    dx, dy : float
        Grid spacing along the second / first axis (``dy`` is signed: grids
        stored north-up have ``dy < 0``).
    offset : (off0, off1)
        Start of the inner domain within the outer grid.
    u_xy : optional (A, 2) array
        Pre-computed horizontal marching directions (x, y components) per
        azimuth; defaults to ``(sin a, cos a)`` (planar ENU convention,
        matching horizon_comp.cpp:318-320 with east=x, north=y).
    unroll : int
        Samples per scan iteration; the sample axis is padded to a multiple
        and folded to (A, M/unroll, unroll).

    Returns
    -------
    list of dict (one per phase) of (A, M/unroll, unroll) arrays:
        level 0:  ``i0, j0`` int32, ``fi, fj`` float32, ``s`` and
                  ``s_start`` (= s - 2*step; < 0 disables the parabola);
                  d1 phases add ``q`` / ``t_lo`` — the paired interior-
                  update flags (see below).
        level>0:  ``base_i, base_j, r_i, r_j`` int32, ``s`` float32.

    d1 interior-update pairing
    --------------------------
    One-read (d1) steps are processed in pairs: the first step of a pair
    only point-samples; the second also runs the interior parabola update
    (through the pair's three endpoint samples) over BOTH trailing
    intervals with ``t_lo = 0``.  A trailing odd step runs it over its own
    interval only (``t_lo = step``).  This halves the interior updates.
    Pair parity is GLOBAL (anchored at the first d1 step), so phase splits
    (:func:`mark_safe_phases`) do not change results.
    """
    azim = np.asarray(azim, dtype=np.float64)
    a_num = azim.shape[0]
    off0, off1 = offset
    if u_xy is None:
        u_xy = np.stack([np.sin(azim), np.cos(azim)], axis=-1)
    ux = np.asarray(u_xy[:, 0:1], dtype=np.float64)
    uy = np.asarray(u_xy[:, 1:2], dtype=np.float64)

    # Global d1 pairing anchors: nx_g = last d2 step index, m_max = last
    # dense step index (derived from the s values so phase splits keep the
    # same flags).
    d1_m = [np.round(np.asarray(s, np.float64) / schedule.step)
            .astype(np.int64)
            for ph, s in zip(schedule.phases, schedule.s_values)
            if ph.kind == "d1"]
    nx_g = int(d1_m[0][0]) - 1 if d1_m else 0
    m_max_g = int(d1_m[-1][-1]) if d1_m else 0

    def dense_entry(sv, pad, prefix=""):
        di = sv * uy / dy
        dj = sv * ux / dx
        fi0 = np.floor(di)
        fj0 = np.floor(dj)
        return {
            prefix + "i0": (off0 + pad + fi0).astype(np.int32),
            prefix + "j0": (off1 + pad + fj0).astype(np.int32),
            prefix + "fi": (di - fi0).astype(np.float32),
            prefix + "fj": (dj - fj0).astype(np.float32),
        }

    tables = []
    for phase, s in zip(schedule.phases, schedule.s_values):
        s64 = s.astype(np.float64)[None, :]          # (1, M)
        if phase.kind == "d2":
            entry = dense_entry(s64, phase.pad, "e_")
            entry.update(dense_entry(s64 - schedule.step / 2.0,
                                     phase.pad, "m_"))
            entry["s"] = np.broadcast_to(s64, (a_num, len(s))) \
                .astype(np.float32)
            entry["inv_s"] = np.broadcast_to(1.0 / s64, (a_num, len(s))) \
                .astype(np.float32)
            entry["s_start"] = np.broadcast_to(
                s64 - schedule.step, (a_num, len(s))).astype(np.float32)
        elif phase.kind == "d1":
            entry = dense_entry(s64, phase.pad)
            entry["s"] = np.broadcast_to(s64, (a_num, len(s))) \
                .astype(np.float32)
            entry["inv_s"] = np.broadcast_to(1.0 / s64, (a_num, len(s))) \
                .astype(np.float32)
            entry["s_start"] = np.broadcast_to(
                s64 - 2.0 * schedule.step,
                (a_num, len(s))).astype(np.float32)
            # Paired interior-update flags (global parity; see docstring)
            m_idx = np.round(s64 / schedule.step).astype(np.int64)
            q = ((m_idx - nx_g) % 2 == 0).astype(np.float32)
            t_lo = np.zeros_like(q)
            if (m_max_g - nx_g) % 2 == 1:
                last = m_idx == m_max_g
                q = np.where(last, np.float32(1.0), q)
                t_lo = np.where(last, np.float32(schedule.step), t_lo)
            entry["q"] = q.astype(np.float32)
            entry["t_lo"] = t_lo.astype(np.float32)
        else:
            k = 2 ** phase.level
            # Mip sample indices in FLOAT32 (s = s0 + m*step clamped to
            # dist; shift = round(s * (u/d))): the round() is
            # discontinuous, and a 1-ulp f32-vs-f64 difference at a
            # boundary reads the neighbouring max-pooled block — which can
            # differ by the whole inter-block relief on rough terrain.
            s0 = np.float32(s[0])
            st_l = np.float32(s[1] - s[0]) if len(s) > 1 else np.float32(1)
            m_idx = np.arange(len(s), dtype=np.float32)
            s32 = np.minimum(s0 + m_idx * st_l,
                             np.float32(schedule.dist)).astype(np.float32)
            sh_i = (uy.astype(np.float32)
                    / np.float32(dy)).astype(np.float32)
            sh_j = (ux.astype(np.float32)
                    / np.float32(dx)).astype(np.float32)
            di = np.round((s32[None, :] * sh_i).astype(np.float32))
            dj = np.round((s32[None, :] * sh_j).astype(np.float32))
            ci = off0 + di.astype(np.int64)
            cj = off1 + dj.astype(np.int64)
            entry = {
                "base_i": (ci // k + phase.pad).astype(np.int32),
                "base_j": (cj // k + phase.pad).astype(np.int32),
                "r_i": (ci % k).astype(np.int32),
                "r_j": (cj % k).astype(np.int32),
                "s": np.broadcast_to(s32[None, :], (a_num, len(s)))
                .astype(np.float32),
                "inv_s": np.broadcast_to(1.0 / s32[None, :].astype(
                    np.float64), (a_num, len(s))).astype(np.float32),
            }
        entry = {k2: _pad_unroll(np.ascontiguousarray(
            np.broadcast_to(v, (a_num, v.shape[-1]))), unroll)
            for k2, v in entry.items()}
        tables.append(entry)
    return tables


# ---------------------------------------------------------------------------
# Horizon sweep core
# ---------------------------------------------------------------------------

def horizon_core_fn(z_outer, z_org, z_inner, geom, tables, trig, *,
                    sched_meta, pads, inner_shape, planar, track_dist,
                    outer_shape=None):
    """Horizon sweep core (unjitted — for embedding in ``shard_map`` or
    custom VJPs; the jitted entry is :data:`_horizon_core`).

    z_outer : (H, W) outer heightfield, or a tuple of *pre-built padded
              pyramid levels* (multi-resolution terrain; see ops.multires) —
              then ``outer_shape`` gives the valid fine-grid extent
    z_org   : (in0, in1) ray-origin elevation (terrain + lift)
    z_inner : (in0, in1) terrain elevation at the inner cells
    geom    : None (planar) or dict with per-cell float32 (in0, in1) fields
              ``ex, ey, ez, nx2, ny2, nz2, mx, my, mz`` = east / north / norm
              components
    tables  : shift tables (pytree of (A, Mu, U) arrays)
    trig    : dict with ``sin``, ``cos``, ``ux``, ``uy`` (A,) arrays
    """
    num_levels = len(pads)
    if isinstance(z_outer, (tuple, list)):
        pyramid = list(z_outer)
        assert outer_shape is not None
    else:
        pyramid = mip.padded_pyramid(z_outer, num_levels, pads)
        outer_shape = z_outer.shape

    def azim_body(_, xs):
        if not planar:
            sin_a = xs["sin"]
            cos_a = xs["cos"]
            # Per-cell in-plane azimuth direction u = sin*east + cos*north
            ucx = sin_a * geom["ex"] + cos_a * geom["nx2"]
            ucy = sin_a * geom["ey"] + cos_a * geom["ny2"]
            ucz = sin_a * geom["ez"] + cos_a * geom["nz2"]
            # Global horizontal marching direction
            gx = xs["ux"]
            gy = xs["uy"]
            a_n = gx * geom["mx"] + gy * geom["my"]     # u_bar . norm_xy
            a_u = gx * ucx + gy * ucy                   # u_bar . u_cell_xy
            nz = geom["mz"]

        def ratio_at(h, s, inv_s=None):
            """Elevation-angle ratio of sample (h at arc s) in the local
            frame.  ``inv_s`` (scalar 1/s) avoids the vector division on
            the planar fast path."""
            if planar:
                if inv_s is not None:
                    return (h - z_org) * inv_s
                return (h - z_org) / s
            dh = h - z_org
            num = s * a_n + dh * nz
            den = s * a_u + dh * ucz
            return jnp.where(den > _DEN_EPS,
                             num / jnp.maximum(den, _DEN_EPS),
                             jnp.where(num > 0.0, -_NEG_INIT, _NEG_INIT))

        # Derive carry initialisers from z_inner (not fresh constants) so
        # their device-varying type matches the loop outputs under shard_map.
        ratio0 = z_inner * 0.0 + _NEG_INIT
        dist0 = z_inner * 0.0
        valid0 = z_inner == z_inner

        def upd(ratio, dist, r_new, s_new):
            if track_dist:
                dist = jnp.where(r_new > ratio, s_new, dist)
            return jnp.maximum(ratio, r_new), dist

        ratio = ratio0
        dist = dist0
        # dense-history carry threads across the d2 -> d1 phase boundary
        h1 = z_inner
        h2 = z_inner
        v1 = valid0
        v2 = valid0
        def interior_update(ratio, dist, a_c, b_c, h0, t, valid, s_start):
            """Max-update with the parabola's interior stationary value.

            At the stationary point of (P(t))/(s+t), the ratio equals the
            parabola's *derivative* there: P'(t*) (s+t*) = P(t*) implies
            f(t*) = P'(t*) = 2 a t* + b — division-free on the planar
            path."""
            s_t = s_start + t
            if planar:
                r_int = jnp.where(valid, 2.0 * a_c * t + b_c, _NEG_INIT)
            else:
                h_t = a_c * t * t + b_c * t + h0
                r_int = jnp.where(
                    valid & (s_t > _DEN_EPS),
                    ratio_at(h_t, jnp.maximum(s_t, _DEN_EPS)),
                    _NEG_INIT)
            return upd(ratio, dist, r_int, s_t)

        for p, (kind, level, pad, _, safe) in enumerate(sched_meta):
            ph = xs[f"p{p}"]
            zp = pyramid[level]

            def mask_of(i0, j0, fi, fj, pad=pad, safe=safe):
                if safe:
                    return valid0
                return _inside_mask(i0, j0, fi, fj, pad, inner_shape,
                                    outer_shape)

            if kind == "d2":
                # Near field: midpoint + endpoint reads; exact parabola per
                # one-step window [s - step, s]
                def body2(c, x, mask_of=mask_of):
                    ratio, dist, h1, h2, v1, v2 = c
                    for u in range(x["s"].shape[-1]):
                        s_end = x["s"][..., u]
                        s_start = x["s_start"][..., u]
                        hm = _read_dense(zp, x["m_i0"][..., u],
                                         x["m_j0"][..., u],
                                         x["m_fi"][..., u],
                                         x["m_fj"][..., u], inner_shape)
                        he = _read_dense(zp, x["e_i0"][..., u],
                                         x["e_j0"][..., u],
                                         x["e_fi"][..., u],
                                         x["e_fj"][..., u], inner_shape)
                        ratio, dist = upd(
                            ratio, dist,
                            ratio_at(he, s_end, x["inv_s"][..., u]), s_end)
                        v_mid = mask_of(x["m_i0"][..., u],
                                        x["m_j0"][..., u],
                                        x["m_fi"][..., u],
                                        x["m_fj"][..., u])
                        v_end = mask_of(x["e_i0"][..., u],
                                        x["e_j0"][..., u],
                                        x["e_fi"][..., u],
                                        x["e_fj"][..., u])
                        length = s_end - s_start
                        a_c, b_c = _segment_quad_coeffs(h1, hm, he, length)
                        t, valid = _segment_interior_t(
                            a_c, b_c, h1, z_org, s_start, length)
                        valid = valid & v1 & v_mid & v_end
                        ratio, dist = interior_update(
                            ratio, dist, a_c, b_c, h1, t, valid, s_start)
                        h2, v2 = h1, v1
                        h1, v1 = he, v_end
                    return (ratio, dist, h1, h2, v1, v2), None
                carry = (ratio, dist, h1, h2, v1, v2)
                (ratio, dist, h1, h2, v1, v2), _ = lax.scan(body2, carry,
                                                            ph)
            elif kind == "d1":
                # Mid field: one read per step; interior parabola updates
                # run on PAIRED steps only (flags ``q``/``t_lo`` — see
                # horizon_shift_tables).
                def body1(c, x, mask_of=mask_of):
                    ratio, dist, h1, h2, v1, v2 = c
                    for u in range(x["s"].shape[-1]):
                        i0 = x["i0"][..., u]
                        j0 = x["j0"][..., u]
                        fi = x["fi"][..., u]
                        fj = x["fj"][..., u]
                        s_end = x["s"][..., u]
                        s_start = x["s_start"][..., u]
                        he = _read_dense(zp, i0, j0, fi, fj, inner_shape)
                        ratio, dist = upd(
                            ratio, dist,
                            ratio_at(he, s_end, x["inv_s"][..., u]), s_end)
                        v_end = mask_of(i0, j0, fi, fj)
                        length = s_end - s_start
                        a_c, b_c = _segment_quad_coeffs(h2, h1, he, length)
                        t, valid = _segment_interior_t(
                            a_c, b_c, h2, z_org, s_start, length,
                            t_lo=x["t_lo"][..., u])
                        valid = valid & v2 & v1 & v_end \
                            & (x["q"][..., u] > 0.5)
                        ratio, dist = interior_update(
                            ratio, dist, a_c, b_c, h2, t, valid, s_start)
                        h2, v2 = h1, v1
                        h1, v1 = he, v_end
                    return (ratio, dist, h1, h2, v1, v2), None
                carry = (ratio, dist, h1, h2, v1, v2)
                (ratio, dist, h1, h2, v1, v2), _ = lax.scan(body1, carry,
                                                            ph)
            else:
                def bodyl(c, x, level=level):
                    ratio, dist = c
                    for u in range(x["s"].shape[-1]):
                        h = _read_mip(zp, level,
                                      x["base_i"][..., u],
                                      x["base_j"][..., u],
                                      x["r_i"][..., u],
                                      x["r_j"][..., u], inner_shape)
                        ratio, dist = upd(ratio, dist,
                                          ratio_at(h, x["s"][..., u],
                                                   x["inv_s"][..., u]),
                                          x["s"][..., u])
                    return (ratio, dist), None
                (ratio, dist), _ = lax.scan(bodyl, (ratio, dist), ph)

        return None, (jnp.arctan(ratio), dist)

    xs_all = dict(trig)
    for p, t in enumerate(tables):
        xs_all[f"p{p}"] = t
    _, (hori_a, dist_a) = lax.scan(azim_body, None, xs_all)
    # (A, in0, in1) -> (in0, in1, A)
    out = jnp.moveaxis(hori_a, 0, -1)
    if track_dist:
        return out, jnp.moveaxis(dist_a, 0, -1)
    return out, None


#: Jitted entry for :func:`horizon_core_fn`.
_horizon_core = functools.partial(
    jax.jit,
    static_argnames=("sched_meta", "pads", "inner_shape", "planar",
                     "track_dist", "outer_shape"))(
    horizon_core_fn)


def horizon_sweep(z_outer, *, dx, dy, offset, inner_shape, azim, dist_search,
                  hori_acc=0.25, elev_ang_low_lim=-15.0,
                  elev_ang_up_lim=89.98, ray_org_elev=0.01, geom=None,
                  u_xy=None, rel_err=None, max_level=10, track_dist=False,
                  schedule=None):
    """Compute horizon elevation angles for a gridded domain.

    Equivalent of ``horizon_gridded_comp`` (horizon_comp.cpp:629-822);
    all azimuths and all cells are computed in one jitted sweep.

    Parameters
    ----------
    z_outer : (H, W) array
        Outer-domain heightfield (z/elevation of each vertex) [metre].
    dx, dy : float
        Grid spacing (dy signed; north-up grids have dy < 0).
    offset : (off0, off1)
        Inner-domain offset within the outer grid (horizon.pyx:112-115).
    inner_shape : (in0, in1)
    azim : (A,) array [radian]
    dist_search : float [metre]
    hori_acc : float [degree] — accuracy knob (drives the sample density).
    geom : optional dict of per-cell basis fields for the general mode (see
        :func:`_horizon_core`); ``None`` selects the planar fast path.
    u_xy : optional (A, 2) horizontal marching directions (general mode).
    track_dist : bool — also return the distance at which the horizon was
        found (reference ray_*_hori_dist, horizon_comp.cpp:519-612).

    Returns
    -------
    hori : (in0, in1, A) float32 [radian], clipped to
        [elev_ang_low_lim, elev_ang_up_lim]
    dist : (in0, in1, A) float32 [metre] or None
    """
    z_outer = jnp.asarray(z_outer, dtype=jnp.float32)
    step = min(abs(dx), abs(dy))
    if rel_err is None:
        rel_err = default_rel_err(hori_acc)
    if schedule is None:
        schedule = build_schedule(step, dist_search, rel_err,
                                  max_level=max_level)
    # Flag dense samples that provably stay on-grid (skips per-sample masks)
    h_out, w_out = z_outer.shape
    halo = min(offset[0], offset[1],
               h_out - offset[0] - inner_shape[0],
               w_out - offset[1] - inner_shape[1])
    schedule = mark_safe_phases(schedule, halo)
    azim = np.asarray(azim, dtype=np.float64)
    tables_np = horizon_shift_tables(schedule, azim, dx, dy, offset,
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
    off0, off1 = offset
    in0, in1 = inner_shape
    z_inner = lax.dynamic_slice(z_outer, (off0, off1), (in0, in1))
    planar = geom is None
    if planar:
        z_org = z_inner + jnp.float32(ray_org_elev)
        geom_in = None
    else:
        geom_in = {k: jnp.asarray(v, dtype=jnp.float32)
                   for k, v in geom.items()}
        z_org = z_inner + jnp.float32(ray_org_elev) * geom_in["mz"]

    hori, dist = _horizon_core(
        z_outer, z_org, z_inner, geom_in, tables, trig,
        sched_meta=schedule.meta(), pads=schedule.pads,
        inner_shape=tuple(inner_shape), planar=planar,
        track_dist=track_dist)
    lo = math.radians(elev_ang_low_lim)
    hi = math.radians(elev_ang_up_lim)
    hori = jnp.clip(hori, lo, hi)
    return (hori, dist) if track_dist else (hori, None)


# ---------------------------------------------------------------------------
# Shadow sweep core (traced marching direction)
# ---------------------------------------------------------------------------

def shadow_metric_core_fn(z_outer, z_org, z_inner, m_slope, u_cells,
                          s_phases, *, sched_meta, pads, offset, inner_shape,
                          row_shift=0):
    """Maximum over the sun ray of ``h(s) - (z_org + s * m_slope)``
    (unjitted core; the jitted entry is :data:`_shadow_metric_core`).

    ``u_cells`` is the traced horizontal marching direction (2,) in *grid
    cells per metre*: ``(ui, uj) = (uy/dy, ux/dx)``; ``m_slope`` is the
    per-cell sun-ray slope dz/ds [m per metre of horizontal arc].  A positive
    result means the sun ray is occluded by terrain (the vectorised
    equivalent of reference shadow_comp.cpp:454-467, rtcOccluded1 with
    tfar = inf).  Level-0 steps include the interior parabola maximum over
    the trailing two-step window (the stationary point of
    ``h(t) - m t`` is the parabola vertex).
    """
    num_levels = len(pads)
    pyramid = mip.padded_pyramid(z_outer, num_levels, pads)
    metric = z_inner * 0.0 + _NEG_INIT
    off0, off1 = offset
    # row_shift: traced extra row offset (sharded execution: each shard's
    # rows start at tile_index * rows)
    off0 = off0 + row_shift
    ui = u_cells[0]   # row cells per metre
    uj = u_cells[1]   # column cells per metre
    outer_shape = z_outer.shape

    def dense_start(s):
        di = s * ui
        dj = s * uj
        fi0 = jnp.floor(di)
        fj0 = jnp.floor(dj)
        return (fi0.astype(jnp.int32), fj0.astype(jnp.int32),
                di - fi0, dj - fj0)

    h1 = z_inner
    h2 = z_inner
    v1 = z_inner == z_inner
    v2 = v1
    for p, (kind, level, pad, *_rest) in enumerate(sched_meta):
        s_arr = s_phases[p]
        zp = pyramid[level]
        if level == 0:
            # The trailing parabola window spans the last two steps;
            # step length comes from consecutive s values in the carry.
            def body0_fixed(c, s_blk, zp=zp, pad=pad):
                metric, h1, h2, v1, v2, s_last = c
                for u in range(s_blk.shape[-1]):
                    s = s_blk[u]
                    # padded duplicate samples give step_len 0 -> guard
                    step_len = jnp.maximum(s - s_last, 1e-3)
                    s_start = s - 2.0 * step_len
                    length = 2.0 * step_len
                    i0, j0, fi, fj = dense_start(s)
                    ii = i0 + (off0 + pad)
                    jj = j0 + (off1 + pad)
                    he = _read_dense(zp, ii, jj, fi, fj, inner_shape)
                    metric = jnp.maximum(metric,
                                         he - z_org - s * m_slope)
                    v_end = _inside_mask(ii, jj, fi, fj, pad, inner_shape,
                                         outer_shape)
                    a_c, b_c = _segment_quad_coeffs(h2, h1, he, length)
                    t = (m_slope - b_c) / jnp.where(
                        jnp.abs(a_c) > 1e-12, 2.0 * a_c,
                        jnp.float32(1e-12))
                    valid = (jnp.abs(a_c) > 1e-12) & (a_c < 0.0) \
                        & (t > 0.5 * length) & (t < length) \
                        & v2 & v1 & v_end & (s_start > -1e-6)
                    g_t = (a_c * t * t + b_c * t + h2
                           - z_org - (s_start + t) * m_slope)
                    metric = jnp.maximum(
                        metric, jnp.where(valid, g_t, _NEG_INIT))
                    h2, v2 = h1, v1
                    h1, v1 = he, v_end
                    s_last = s
                return (metric, h1, h2, v1, v2, s_last), None
            carry = (metric, h1, h2, v1, v2, jnp.float32(0.0))
            (metric, h1, h2, v1, v2, _), _ = lax.scan(
                body0_fixed, carry, s_arr)
        else:
            k = 2 ** level
            def bodyl(c, s_blk, k=k, zp=zp, pad=pad, level=level):
                metric = c
                for u in range(s_blk.shape[-1]):
                    s = s_blk[u]
                    ci = jnp.round(s * ui).astype(jnp.int32) + off0
                    cj = jnp.round(s * uj).astype(jnp.int32) + off1
                    base_i = jnp.floor_divide(ci, k) + pad
                    base_j = jnp.floor_divide(cj, k) + pad
                    r_i = jnp.mod(ci, k)
                    r_j = jnp.mod(cj, k)
                    h = _read_mip(zp, level, base_i, base_j, r_i, r_j,
                                  inner_shape)
                    metric = jnp.maximum(metric, h - z_org - s * m_slope)
                return metric, None

            # Provably-safe phase skip (shadow_comp.cpp:454-467's
            # tfar semantics make far samples pointless for low sun over
            # low terrain).  The phase can be skipped when no cell's
            # metric can rise: the level's terrain maximum minus the
            # smallest ray drop already loses to every current metric.
            # (An "every cell already occluded" arm would also preserve
            # the sign, but its firing depends on the local domain, which
            # breaks value equality between sharded and single-device
            # runs — so only the exact bound is used.)
            z_top = jnp.max(zp)
            s_first = s_arr[0, 0]
            s_last = s_arr[-1, -1]
            gain = z_top - z_org - jnp.minimum(s_first * m_slope,
                                               s_last * m_slope)
            skip = jnp.max(gain - metric) <= 0.0
            metric = lax.cond(
                skip, lambda mm: mm,
                lambda mm: lax.scan(bodyl, mm, s_arr)[0], metric)
    return metric


#: Jitted entry for :func:`shadow_metric_core_fn`.
_shadow_metric_core = functools.partial(
    jax.jit,
    static_argnames=("sched_meta", "pads", "offset", "inner_shape"))(
    shadow_metric_core_fn)


def shadow_metric(z_outer, z_org, z_inner, m_slope, u_cells, schedule,
                  offset, inner_shape):
    """Run the shadow occlusion sweep; see :func:`_shadow_metric_core`."""
    s_phases = tuple(
        jnp.asarray(_pad_unroll(s[None, :], UNROLL)[0]) for s in
        schedule.s_values)
    return _shadow_metric_core(
        z_outer, z_org, z_inner, m_slope,
        jnp.asarray(u_cells, dtype=jnp.float32),
        s_phases,
        sched_meta=schedule.meta(),
        pads=schedule.pads, offset=(int(offset[0]), int(offset[1])),
        inner_shape=tuple(inner_shape))

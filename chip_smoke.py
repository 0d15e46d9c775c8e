#!/usr/bin/env python
# Copyright (c) 2026
# MIT License
"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases 0-5
    python chip_smoke.py --four-cards   # four cards: the sharded phase only

Phases (one process; any failed check raises and the script exits
non-zero without printing the final line):

0. device: refuses to run unless JAX's first device is a GPU.
1. planar: ``models.PlanarPipeline`` (horizon + slope + SVF) at the
   published domain of the reference's DHM25 workflow
   (examples/horizon/gridded_planar_dem.py: 39 x 28 km at 25 m, 20 km search,
   180 azimuths, hori_acc 0.25 deg) on seeded synthetic terrain, checked
   against the native ray-marcher ``native/fastdem.horizon_march``: within
   hori_acc over the sweep's dense range; over the full search never below
   it by more than hori_acc, and above it by at most the conservative
   max-mip far field's bound (a known defect, see README).
2. shadow: the reference's artificial-hemisphere validation, then a
   one-day sun track over phase 1's domain against ``fastdem.shadow_march``.
3. curved + locations: ``models.CurvedPipeline`` at the curved example's
   synthetic default, then ``horizon_locations`` at sampled inner cells.
4. gradient: examples/horizon/terrain_fit_gradient.py at its defaults,
   against central finite differences along smooth directions.
5. GPU test tier: ``pytest -m gpu`` in this process.

``--four-cards`` runs the sharded sweep, its gradient and the sharded
shadow metric over a 4 x 1 (tile x azim) mesh against one card.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# DHM25 domain of examples/horizon/gridded_planar_dem.py:58-59
DX = 25.0
INNER = (1120, 1560)          # 28 km x 39 km
DIST_KM = 20.0
AZIM_NUM = 180
HORI_ACC = 0.25
WINDOW = 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def _load_example(rel_path):
    path = os.path.join(REPO, rel_path)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wall(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 0: device
# ---------------------------------------------------------------------------

def phase_device(count):
    import jax

    from horayzon_tpu.utils import profiling

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"needs an NVIDIA GPU, JAX found {devs[0].platform}")
    check(len(devs) >= count, f"needs {count} GPUs, JAX found {len(devs)}")
    cache = profiling.use_compile_cache(os.path.join(REPO, ".jax_cache"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {devs[0].device_kind} x {len(devs)}; nvidia-smi: "
        f"{' | '.join(smi.splitlines())}; jax {jax.__version__}; "
        f"compile cache {cache}")
    for line in smi.splitlines():
        log(line)
    return devs


# ---------------------------------------------------------------------------
# Phase 1: planar DHM25 domain
# ---------------------------------------------------------------------------

def planar_domain(inner=INNER, dist_km=DIST_KM, dx=DX, seed=0):
    """Seeded DHM25-like terrain around an ``inner``-cell domain with a
    ``dist_km`` search halo: (x, y, elevation, domain)."""
    example = _load_example("examples/horizon/gridded_planar_dem.py")
    halo = int(round(dist_km * 1000.0 / dx))
    rows, cols = inner[0] + 2 * halo, inner[1] + 2 * halo
    x, y, z = example.synthetic_dhm25_like(n=max(rows, cols), dx=dx,
                                           seed=seed)
    x, y, z = x[:cols], y[:rows], np.ascontiguousarray(z[:rows, :cols])
    domain = {"x_min": float(x[halo]), "x_max": float(x[halo + inner[1] - 1]),
              "y_max": float(y[halo]), "y_min": float(y[halo + inner[0] - 1])}
    return x, y, z, domain


def phase_planar(inner=INNER, dist_km=DIST_KM, azim_num=AZIM_NUM,
                 window=WINDOW):
    import jax

    import horayzon_tpu as hray
    from horayzon_tpu.native import fastdem
    from horayzon_tpu.ops import sweep

    x, y, z, domain = planar_domain(inner, dist_km)
    pipe = hray.models.PlanarPipeline(x, y, z, domain, dist_search=dist_km,
                                      azim_num=azim_num, hori_acc=HORI_ACC)
    in_shape = (pipe.slice_in[0].stop - pipe.slice_in[0].start,
                pipe.slice_in[1].stop - pipe.slice_in[1].start)
    check(in_shape == tuple(inner), f"inner domain {in_shape} != {inner}")
    out, cold = _wall(pipe.run)
    out, warm = _wall(pipe.run)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    hori = out["hori"]
    check(hori.shape == tuple(inner) + (azim_num,), f"hori {hori.shape}")
    check(np.isfinite(hori).all(), "non-finite horizon")
    svf = out["svf"]
    check(np.isfinite(svf).all() and svf.min() > 0.0
          and svf.max() <= 1.0 + 1e-6,
          f"SVF outside (0, 1]: {svf.min()} .. {svf.max()}")
    log(f"[planar] {inner[0]}x{inner[1]} cells x {azim_num} azimuths, "
        f"outer {z.shape}: cold {cold:.3f} s (with compile), "
        f"warm {warm:.3f} s, peak_bytes_in_use {peak}; "
        f"SVF {svf.min():.4f} .. {svf.max():.4f}")

    # Oracle windows: one central, one touching the inner edge.  Within
    # the dense (level-0) range the sweep reads the bilinear surface along
    # the exact ray, so it must agree with the ray-marcher within hori_acc.
    # Beyond it the max-mip far field is conservative: a pooled block also
    # holds terrain beside the ray.  That excess over hori_acc is a known
    # defect (README "Accuracy contract"); until the schedule is fixed the
    # full-range horizon is held to never fall short of the oracle by more
    # than hori_acc, and to exceed it by at most the far field's bound: a
    # block diagonal of up to 2 * sqrt(2) * rel_err of the distance, times
    # a terrain slope of at most 1.
    off = (pipe.offset_0, pipe.offset_1)
    azim = out["azim"].astype(np.float64)
    dy = float(y[1] - y[0])
    sched = sweep.build_schedule(DX, dist_km * 1000.0,
                                 sweep.default_rel_err(HORI_ACC))
    dense_m = max(float(sv[-1]) for ph, sv in zip(sched.phases,
                                                   sched.s_values)
                  if ph.level == 0)
    far_cap = math.degrees(2.0 * math.sqrt(2.0)
                           * sweep.default_rel_err(HORI_ACC))
    for name, (r0, c0) in (("central", ((inner[0] - window) // 2,
                                        (inner[1] - window) // 2)),
                           ("edge", (0, 0))):
        w_off = (off[0] + r0, off[1] + c0)
        h_dense, _ = sweep.horizon_sweep(
            z, dx=DX, dy=dy, offset=w_off, inner_shape=(window, window),
            azim=azim, dist_search=dense_m, hori_acc=HORI_ACC)
        ref_dense, _ = fastdem.horizon_march(
            z, DX, dy, w_off, (window, window), azim, dense_m, step=DX / 2)
        dd = np.rad2deg(np.abs(np.asarray(h_dense) - ref_dense))
        ref, _ = fastdem.horizon_march(
            z, DX, dy, w_off, (window, window), azim, dist_km * 1000.0,
            step=DX / 2)
        d = np.rad2deg(hori[r0:r0 + window, c0:c0 + window] - ref)
        log(f"[planar] {name} {window}x{window} window vs "
            f"fastdem.horizon_march: dense range ({dense_m:.0f} m) max "
            f"|d| {dd.max():.4f} deg (limit {HORI_ACC}); full "
            f"{dist_km:.0f} km pipeline output d = sweep - oracle in "
            f"[{d.min():.4f}, {d.max():.4f}] deg, p99.9 |d| "
            f"{np.percentile(np.abs(d), 99.9):.4f} deg, share of |d| > "
            f"{HORI_ACC}: {(np.abs(d) > HORI_ACC).mean():.5f} (limits: d >= "
            f"-{HORI_ACC}; d <= far-field bound {far_cap:.4f})")
        check(dd.max() <= HORI_ACC,
              f"{name} window dense range off by {dd.max()} deg")
        check(d.min() >= -HORI_ACC,
              f"{name} window below the oracle by {-d.min()} deg")
        check(d.max() <= far_cap,
              f"{name} window above the oracle by {d.max()} deg")
    return x, y, z, pipe, out


# ---------------------------------------------------------------------------
# Phase 2: shadow
# ---------------------------------------------------------------------------

def phase_shadow_hemisphere(dx=100.0, azim_steps=181, elev=30.0):
    example = _load_example("examples/shadow/gridded_planar_dem_artificial.py")
    terrain, _, _ = example.hemisphere_terrain(dx)
    _, suns = example.rotating_sun(azim_steps, elev)
    sw, wall = _wall(lambda: terrain.sw_dir_cor_batch(suns))
    codes = terrain.shadow_batch(suns)
    means = sw.mean(axis=(1, 2))
    log(f"[shadow] hemisphere {sw.shape[1]}x{sw.shape[2]} x {azim_steps} "
        f"suns: spatial-mean sw_dir_cor {means.min():.4f} .. "
        f"{means.max():.4f} (limit 1 +- 0.03), {wall:.3f} s with compile")
    check(np.abs(means - 1.0).max() <= 0.03, "hemisphere mean off")
    check(set(np.unique(codes).tolist()) <= {0, 1, 2, 3},
          f"shadow codes {np.unique(codes)}")


def day_track(hours=24, lon=7.9, lat=46.6, day="2024-06-21"):
    """Hourly planar sun positions [m] for one day (UTC)."""
    import horayzon_tpu as hray

    times = np.datetime64(day) + np.arange(hours) * np.timedelta64(1, "h")
    az, el = hray.sun_position.sun_azimuth_elevation(times, lon, lat)
    return el, hray.sun_position.sun_position_planar(az, el, dist=1.0e9)


def phase_shadow_track(x, y, z, pipe, out, window=WINDOW):
    import horayzon_tpu as hray
    from horayzon_tpu.native import fastdem

    in_shape = out["svf"].shape
    vec_norm = np.zeros(in_shape + (3,), np.float32)
    vec_norm[..., 2] = 1.0
    vec_tilt = np.ascontiguousarray(out["vec_tilt"])
    surf = hray.topo_param.surface_enlargement_factor(vec_norm, vec_tilt)
    xx, yy = np.meshgrid(x, y)
    terrain = hray.shadow.Terrain()
    terrain.initialise(
        hray.auxiliary.rearrange_pad_buffer(xx, yy, z), z.shape[0],
        z.shape[1], pipe.offset_0, pipe.offset_1, vec_tilt, vec_norm, surf,
        np.ascontiguousarray(out["elevation"]),
        np.ones(in_shape, np.uint8))
    el, suns = day_track()
    codes, t_sh = _wall(lambda: terrain.shadow_batch(suns))
    sw, t_sw = _wall(lambda: terrain.sw_dir_cor_batch(suns))
    check(set(np.unique(codes).tolist()) <= {0, 1, 2, 3}, "shadow codes")
    check(np.isfinite(sw).all(), "non-finite sw_dir_cor")
    log(f"[shadow] day track {len(suns)} suns on {in_shape}: shadow "
        f"{t_sh:.3f} s, sw_dir_cor {t_sw:.3f} s (each with compile); "
        f"sun elevation {el.min():.1f} .. {el.max():.1f} deg")

    # fastdem.shadow_march marches from x = j*dx, y = i*dy: shift the sun
    # into that frame (the grid's first row sits at y[0])
    r0 = (in_shape[0] - window) // 2
    c0 = (in_shape[1] - window) // 2
    dy = float(y[1] - y[0])
    sl = (slice(r0, r0 + window), slice(c0, c0 + window))
    agree, n_cmp = 0, 0
    for t in np.flatnonzero(el > 2.0):
        sun = suns[t].astype(np.float64) - np.array([x[0], y[0], 0.0])
        occ = fastdem.shadow_march(
            z, DX, dy, (pipe.offset_0 + r0, pipe.offset_1 + c0),
            (window, window), sun, step=DX / 2).astype(bool)
        lit_side = codes[t][sl] != 1           # not self-shaded
        agree += int(((codes[t][sl] == 2) == occ)[lit_side].sum())
        n_cmp += int(lit_side.sum())
    frac = agree / max(n_cmp, 1)
    log(f"[shadow] {window}x{window} window vs fastdem.shadow_march over "
        f"{int((el > 2.0).sum())} daytime suns: terrain-shadow agreement "
        f"{frac:.5f} of {n_cmp} cell-suns (limit 0.98)")
    check(n_cmp > 0 and frac >= 0.98, f"shadow agreement {frac}")


# ---------------------------------------------------------------------------
# Phase 3: curved + locations
# ---------------------------------------------------------------------------

def phase_curved(n=900, n_locations=16, pad=0.25, dist_km=20.0,
                 azim_num=120):
    import horayzon_tpu as hray

    example = _load_example("examples/horizon/gridded_curved_dem.py")
    lon, lat, elevation = example.synthetic_srtm_like(n=n)
    domain = {"lon_min": float(lon.min()) + pad,
              "lon_max": float(lon.max()) - pad,
              "lat_min": float(lat.min()) + pad,
              "lat_max": float(lat.max()) - pad}
    pipe = hray.models.CurvedPipeline(lon, lat, elevation, domain,
                                      dist_search=dist_km,
                                      azim_num=azim_num, ellps="WGS84")
    out, wall = _wall(pipe.run)
    hori, svf = out["hori"], out["svf"]
    check(np.isfinite(hori).all() and np.isfinite(svf).all(),
          "non-finite curved output")
    # horizons below the local horizontal (Earth curvature) can lift the
    # SVF a little above 1
    check(svf.min() > 0.0 and svf.max() <= 1.001,
          f"curved SVF range {svf.min()} .. {svf.max()}")
    log(f"[curved] CurvedPipeline {hori.shape}: {wall:.3f} s with compile; "
        f"SVF {svf.min():.4f} .. {svf.max():.4f}")

    rng = np.random.default_rng(1)
    ii = rng.integers(0, hori.shape[0], n_locations)
    jj = rng.integers(0, hori.shape[1], n_locations)
    gi, gj = ii + pipe.offset_0, jj + pipe.offset_1
    coords = np.stack([pipe.x[gi, gj], pipe.y[gi, gj], pipe.z[gi, gj]],
                      axis=-1).astype(np.float32)
    h_loc, _ = hray.horizon.horizon_locations(
        hray.auxiliary.rearrange_pad_buffer(pipe.x, pipe.y, pipe.z),
        pipe.elevation.shape[0], pipe.elevation.shape[1], coords,
        pipe.vec_norm[ii, jj], pipe.vec_north[ii, jj], dist_km,
        azim_num=azim_num, hori_acc=HORI_ACC,
        elev_ang_low_lim=pipe.elev_ang_low_lim)
    d = np.rad2deg(np.abs(hori[ii, jj] - h_loc))
    log(f"[curved] horizon_locations at {n_locations} cells vs gridded: "
        f"max |d| {d.max():.4f} deg (limit 0.3 deg)")
    check(d.max() <= 0.3, f"locations off by {d.max()} deg")


# ---------------------------------------------------------------------------
# Phase 4: gradient
# ---------------------------------------------------------------------------

def phase_gradient(steps=None, probes=3, sigma=12.0, eps=1.0, rtol=0.05):
    """Autodiff at the fit's start against central finite differences of
    the same loss along smooth directions: Gaussian bumps of ``sigma``
    cells at seeded points of the inner domain, ``eps`` metres high.  A
    bump lifts neighbouring cells together, so the running maxima keep
    their winners and the loss is smooth along it; a single-cell or
    white-noise probe flips winners (kinks) instead.  Limit, as in
    tests/test_grad.py: |autodiff - fd| <= ``rtol`` (|autodiff| + |fd|),
    which a zero or wrong-signed gradient fails."""
    import jax
    import jax.numpy as jnp

    example = _load_example("examples/horizon/terrain_fit_gradient.py")
    args = example.build_parser().parse_args([])
    if steps is not None:
        args.steps = steps
    z_true, z_init, loss_fn = example.build_problem(args)
    z0 = jnp.asarray(z_init)
    (loss0, _), g = jax.value_and_grad(loss_fn, has_aux=True)(z0)
    check(np.isfinite(np.asarray(g)).all() and float(jnp.abs(g).max()) > 0,
          "gradient not finite and nonzero")
    loss_j = jax.jit(lambda zz: loss_fn(zz)[0])
    n = z0.shape[0]
    halo = (n - args.inner) // 2
    ii, jj = np.mgrid[0:n, 0:n]
    rng = np.random.default_rng(0)
    for ci, cj in rng.uniform(halo, n - halo, (probes, 2)):
        v = jnp.asarray(np.exp(-((ii - ci) ** 2 + (jj - cj) ** 2)
                               / (2.0 * sigma ** 2)).astype(np.float32))
        an = float(jnp.vdot(g, v))
        lp, lm = float(loss_j(z0 + eps * v)), float(loss_j(z0 - eps * v))
        fd = (lp - lm) / (2.0 * eps)
        log(f"[gradient] bump at ({ci:.1f}, {cj:.1f}), sigma {sigma} cells, "
            f"eps {eps} m: autodiff {an:.5e}, central difference {fd:.5e} "
            f"(loss {float(loss0):.6e} -> {lp:.6e} / {lm:.6e}; limit "
            f"|d| <= {rtol} of the sum of magnitudes)")
        check(abs(an - fd) <= rtol * (abs(an) + abs(fd)),
              f"autodiff {an} vs central difference {fd}")
    (_, losses), wall = _wall(lambda: example.fit(loss_fn, z_init, z_true,
                                                  args.steps, args.lr))
    check(losses[min(9, len(losses) - 1)] < losses[0],
          "loss did not fall over the first 10 steps")
    log(f"[gradient] {args.inner}x{args.inner} x {args.azim_num} azimuths: "
        f"{args.steps} Adam steps in {wall:.3f} s with compile; horizon "
        f"MSE {losses[0]:.4e} -> {losses[min(9, len(losses) - 1)]:.4e} "
        f"(step 10) -> {losses[-1]:.4e} (step {args.steps})")


# ---------------------------------------------------------------------------
# Phase 5: GPU test tier
# ---------------------------------------------------------------------------

class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.passed = 0
        self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        if report.skipped:
            self.skipped += 1


def phase_gpu_tests():
    import pytest

    os.environ["HORAYZON_GPU_TESTS"] = "1"
    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", REPO,
                      os.path.join(REPO, "tests", "test_gpu.py")],
                     plugins=[outcomes])
    check(rc == 0 and outcomes.passed > 0 and outcomes.skipped == 0,
          f"GPU test tier: pytest exit code {rc}, {outcomes.passed} "
          f"passed, {outcomes.skipped} skipped")
    log(f"[gpu tests] {outcomes.passed} passed")


# ---------------------------------------------------------------------------
# --four-cards: sharded paths against one card
# ---------------------------------------------------------------------------

def phase_four_cards(devs, inner=INNER, dist_km=DIST_KM, azim_num=AZIM_NUM):
    import jax
    import jax.numpy as jnp

    from horayzon_tpu.ops import sweep
    from horayzon_tpu.parallel import mesh as pmesh
    from horayzon_tpu.parallel import shard as pshard

    mesh = pmesh.make_mesh(n_tile=4, n_azim=1, devices=devs[:4])
    log(f"[four cards] mesh 4x1 (tile x azim) over device ids "
        f"{[d.id for d in mesh.devices.ravel()]}")
    _, y, z, _ = planar_domain(inner, dist_km)
    halo = int(round(dist_km * 1000.0 / DX))
    azim = (2 * np.pi / azim_num) * np.arange(azim_num)
    kw = dict(dx=DX, dy=float(y[1] - y[0]), offset=(halo, halo),
              inner_shape=tuple(inner), azim=azim,
              dist_search=dist_km * 1000.0, hori_acc=HORI_ACC)
    with jax.default_device(devs[0]):
        z0 = jnp.asarray(z)
        single, t1 = _wall(lambda: jax.block_until_ready(
            sweep.horizon_sweep(z0, **kw)[0]))
        single = np.asarray(single)
    sharded, t4 = _wall(lambda: jax.block_until_ready(
        pshard.horizon_sweep_sharded(mesh, z, **kw)))
    shard_ids = sorted(s.device.id for s in sharded.addressable_shards)
    d = np.abs(np.asarray(sharded) - single).max()
    log(f"[four cards] horizon {inner} x {azim_num}: sharded vs one card "
        f"max |d| {d:.3e} rad (limit 1e-5); output shards on devices "
        f"{shard_ids}; one card {t1:.3f} s, four cards {t4:.3f} s "
        f"(each with compile)")
    check(len(set(shard_ids)) == 4, "output not spread over four devices")
    check(d <= 1e-5, f"sharded sweep off by {d} rad")

    # value_and_grad at the gradient example's size
    example = _load_example("examples/horizon/terrain_fit_gradient.py")
    args = example.build_parser().parse_args([])
    z_true, _, _ = example.build_problem(args)
    h_g = (args.n - args.inner) // 2
    kw_g = dict(dx=args.dx, dy=-args.dx, offset=(h_g, h_g),
                inner_shape=(args.inner, args.inner),
                azim=(2 * np.pi / args.azim_num) * np.arange(args.azim_num),
                dist_search=args.dist_search * 1000.0, hori_acc=HORI_ACC)

    def loss_single(zz):
        return jnp.mean(sweep.horizon_sweep(zz, **kw_g)[0] ** 2)

    def loss_sharded(zz):
        return jnp.mean(pshard.horizon_sweep_sharded(mesh, zz, **kw_g) ** 2)

    with jax.default_device(devs[0]):
        l1, g1 = jax.value_and_grad(loss_single)(jnp.asarray(z_true))
        g1 = np.asarray(g1)
    l4, g4 = jax.value_and_grad(loss_sharded)(jnp.asarray(z_true))
    gd = np.abs(np.asarray(g4) - g1).max() / np.abs(g1).max()
    log(f"[four cards] value_and_grad {args.inner}^2 x {args.azim_num}: "
        f"loss {float(l4):.8e} vs {float(l1):.8e}; max gradient difference "
        f"{gd:.3e} of max |g| (limit 1e-4)")
    check(np.isfinite(g1).all() and np.abs(g1).max() > 0.0, "gradient")
    check(gd <= 1e-4, f"sharded gradient off by {gd}")

    # shadow metric for one low sun over the planar domain
    step = DX
    diag = math.hypot(z.shape[0] * step, z.shape[1] * step)
    sched = sweep.build_schedule(step, diag, sweep.default_rel_err(HORI_ACC))
    z_in = z[halo:halo + inner[0], halo:halo + inner[1]]
    z_org = z_in + 0.05
    m_slope = np.full(inner, math.tan(math.radians(8.0)), np.float32)
    u_cells = np.array([math.cos(math.radians(135.0)) / kw["dy"],
                        math.sin(math.radians(135.0)) / DX], np.float32)
    with jax.default_device(devs[0]):
        m1 = np.asarray(sweep.shadow_metric(
            jnp.asarray(z), jnp.asarray(z_org), jnp.asarray(z_in),
            jnp.asarray(m_slope), u_cells, sched, (halo, halo), inner))
    m4 = np.asarray(pshard.shadow_metric_sharded(
        mesh, z, z_org, z_in, m_slope, u_cells, sched, (halo, halo), inner))
    dm = np.abs(m4 - m1).max()
    same = ((m4 > 0) == (m1 > 0)).mean()
    log(f"[four cards] shadow metric {inner}: max |d| {dm:.3e} m "
        f"(limit 1e-3), occlusion agreement {same:.6f}")
    check(dm <= 1e-3 and same == 1.0, "sharded shadow metric differs")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase on four GPUs")
    args = ap.parse_args()
    count = 4 if args.four_cards else 1
    devs = phase_device(count)
    if args.four_cards:
        phase_four_cards(devs)
    else:
        x, y, z, pipe, out = phase_planar()
        phase_shadow_hemisphere()
        phase_shadow_track(x, y, z, pipe, out)
        del out
        phase_curved()
        phase_gradient()
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()

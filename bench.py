#!/usr/bin/env python
# Copyright (c) 2026
# MIT License
"""Benchmark: gridded-DEM horizon sweep and shadow track on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Metric accounting
-----------------
The reference's own instrumentation counts *rays shot* and averages
~2 rays/(cell, azimuth) with its guess_constant warm start
(horizon_comp.cpp:807-810).  To compare end-to-end throughput on identical
work, we report "reference-equivalent rays/s":

    rays = num_cells * azim_num * 2.0 ;  rays/s = rays / wall_time

i.e. the rate at which the card produces the same horizon output that Embree
produces with ~2 rays per (cell, azimuth).  ``samples_per_s`` (heightfield
reads/s of the sweep itself) is also reported for kernel-level analysis.

Rows
----
* ``wall_time_s``: ``ops.sweep.horizon_sweep`` on the device, closed by
  ``block_until_ready`` (best of ``--iters``).
* ``horizon_gridded_wall_time_s``: the public ``horizon.horizon_gridded``
  call, which also copies the horizon field to the host.
* ``shadow_s_per_sun_position``: ``shadow.Terrain.sw_dir_cor_batch`` over a
  16-position sun track, per position.
* ``cpu_*`` / ``bvh_*``: measured CPU baselines on the host's cores (native
  ray-marcher and BVH tracer; see BASELINE.md).

Compile time is set-up and is reported separately.  ``--trace DIR`` makes
a run of its own and skips the other rows.  It times the sweep and records
two profiler traces at the same shape:

* ``DIR/sweep``: one warm sweep; the ten device operations that took the
  most time, and the device's busy time within the trace;
* ``DIR/pipeline``: one warm ``models.PlanarPipeline.run`` (horizon, slope,
  SVF) with Python function events: the call's wall time, the device's
  busy time and idle share within it, and the Python functions that took
  the most wall time (inclusive).
"""

import argparse
import contextlib
import glob
import io
import json
import os
import subprocess
import time

import numpy as np

ASSUMED_EMBREE_CPU_RAYS_PER_S = 20.0e6
REF_RAYS_PER_CELL_AZIM = 2.0
REPO = os.path.dirname(os.path.abspath(__file__))


def make_terrain(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    z = np.zeros((h, w), dtype=np.float64)
    for _ in range(24):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sig = rng.uniform(6.0, h / 6.0)
        z += rng.uniform(100, 800) * np.exp(
            -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
    return z.astype(np.float32)


def best_time(run, iters):
    """Compile (first call), then the best wall time of ``iters`` calls,
    each closed by ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(run())
    first = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return min(times), first


def _profile(log_dir):
    """The newest profiler trace under ``log_dir``."""
    import jax

    path = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    return jax.profiler.ProfileData.from_file(path)


def top_device_ops(log_dir, n=10):
    """Device time per operation name over the GPU streams of the newest
    profiler trace under ``log_dir``: (top ``n`` as [name, total_ns,
    count], busy_ns, window_ns).  Busy is the union of the event intervals
    on all streams; the window runs from the first event's start to the
    last one's end."""
    data = _profile(log_dir)
    per_op = {}
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                tot, cnt = per_op.get(ev.name, (0, 0))
                per_op[ev.name] = (tot + ev.duration_ns, cnt + 1)
                spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, cur_lo, cur_hi = 0, None, None
    for lo, hi in spans:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    window = spans[-1][1] - spans[0][0] if spans else 0
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:n]
    return [[k, v[0], v[1]] for k, v in top], busy, window


def top_host_calls(log_dir, n=20):
    """This package's and numpy's Python functions in the newest trace
    under ``log_dir`` (recorded with ``python_tracer_level=1``) by
    inclusive wall time, each under its nearest such caller, as
    ["caller > name", total_ns, count]."""
    pkg = {os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "horayzon_tpu", "**", "*.py"), recursive=True)}
    data = _profile(log_dir)
    per_fn = {}
    for plane in data.planes:
        if not plane.name.startswith("/host:"):
            continue
        for line in plane.lines:
            if line.name != "python":
                continue
            stack = []          # (end_ns, nearest kept caller's name)
            for ev in sorted(line.events,
                             key=lambda e: (e.start_ns, -e.duration_ns)):
                while stack and stack[-1][0] <= ev.start_ns:
                    stack.pop()
                caller = stack[-1][1] if stack else ""
                kept = (ev.name.startswith("$numpy")
                        or ev.name[1:].split(":")[0] in pkg)
                stack.append((ev.end_ns, ev.name if kept else caller))
                if kept:
                    key = f"{caller} > {ev.name}" if caller else ev.name
                    tot, cnt = per_fn.get(key, (0, 0))
                    per_fn[key] = (tot + ev.duration_ns, cnt + 1)
    top = sorted(per_fn.items(), key=lambda kv: -kv[1][0])[:n]
    return [[k, v[0], v[1]] for k, v in top]


def trace_pipeline(log_dir, z, dx, halo, inner_shape, dist_km, azim_num,
                   acc, iters):
    """Warm wall time of ``models.PlanarPipeline.run`` over ``z`` (best of
    ``iters``), then one warm call traced with Python function events."""
    import jax

    import horayzon_tpu as hray

    h, w = z.shape
    x = np.arange(w, dtype=np.float32) * dx
    y = -np.arange(h, dtype=np.float32) * dx
    domain = {"x_min": float(x[halo]),
              "x_max": float(x[halo + inner_shape[1] - 1]),
              "y_max": float(y[halo]),
              "y_min": float(y[halo + inner_shape[0] - 1])}
    pipe = hray.models.PlanarPipeline(x, y, z, domain, dist_search=dist_km,
                                      azim_num=azim_num, hori_acc=acc)
    with contextlib.redirect_stdout(io.StringIO()):   # the sweep's report
        wall, first = best_time(pipe.run, iters)
        opts = jax.profiler.ProfileOptions()
        opts.python_tracer_level = 1
        t0 = time.perf_counter()
        with jax.profiler.trace(log_dir, profiler_options=opts):
            pipe.run()
        traced = time.perf_counter() - t0
    top, busy, window = top_device_ops(log_dir)
    calls = top_host_calls(log_dir)
    run_ns = next(ns for name, ns, _ in calls
                  if name.startswith("$pipeline.py:")
                  and name.endswith(" run"))
    return {"pipeline_wall_time_s": wall,
            "pipeline_compile_and_first_call_s": first,
            "pipeline_traced_call_s": traced,
            "pipeline_trace_run_ns": run_ns,
            "pipeline_trace_device_busy_ns": busy,
            "pipeline_trace_device_window_ns": window,
            "pipeline_trace_device_idle_share": 1.0 - busy / run_ns,
            "pipeline_trace_top_device_ops": top,
            "pipeline_trace_top_host_calls": calls}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inner", type=int, nargs="+", default=[1024],
                    help="inner domain cells: one value (square) or "
                         "rows cols")
    ap.add_argument("--halo", type=int, default=512,
                    help="outer halo cells per side")
    ap.add_argument("--azim", type=int, default=32)
    ap.add_argument("--dist", type=float, default=20.0,
                    help="search distance [km]")
    ap.add_argument("--dx", type=float, default=25.0)
    ap.add_argument("--acc", type=float, default=0.25)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu-baseline", action="store_true", default=True)
    ap.add_argument("--no-cpu-baseline", dest="cpu_baseline",
                    action="store_false")
    ap.add_argument("--trace", metavar="DIR",
                    help="record a profiler trace of one warm sweep in DIR")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from horayzon_tpu import auxiliary, horizon, shadow
    from horayzon_tpu.ops import sweep
    from horayzon_tpu.utils import profiling

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    cache = profiling.use_compile_cache(os.path.join(REPO, ".jax_cache"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    in0, in1 = (args.inner * 2)[:2]
    h, w = in0 + 2 * args.halo, in1 + 2 * args.halo
    dx = args.dx
    dist_m = args.dist * 1000.0
    z = make_terrain(h, w)
    azim = (2 * np.pi / args.azim) * np.arange(args.azim)
    z_dev = jnp.asarray(z)
    kw = dict(dx=dx, dy=-dx, offset=(args.halo, args.halo),
              inner_shape=(in0, in1), azim=azim, dist_search=dist_m,
              hori_acc=args.acc)

    def run_sweep():
        return sweep.horizon_sweep(z_dev, **kw)[0]

    dt, dt_first = best_time(run_sweep, args.iters)
    hori_mean = float(jnp.mean(run_sweep()))
    schedule = sweep.build_schedule(dx, dist_m, sweep.default_rel_err(
        args.acc))
    cells = in0 * in1
    rays_per_s = cells * args.azim * REF_RAYS_PER_CELL_AZIM / dt
    samples_per_s = cells * args.azim * schedule.num_samples / dt

    result = {
        "metric": "rays_per_s_per_chip",
        "value": rays_per_s,
        "unit": "reference-equivalent rays/s",
        "vs_baseline": rays_per_s / ASSUMED_EMBREE_CPU_RAYS_PER_S,
        "vs_assumed_embree": rays_per_s / ASSUMED_EMBREE_CPU_RAYS_PER_S,
        "baseline_note": ("vs_baseline assumes a 20M rays/s Embree+TBB "
                          "workstation (reference publishes no numbers); "
                          "vs_measured_bvh_cpu is measured on this "
                          "machine's cores - see BASELINE.md"),
        "wall_time_s": dt,
        "compile_and_first_call_s": dt_first,
        "cells": cells,
        "inner_shape": [in0, in1],
        "azim_num": args.azim,
        "dist_search_km": args.dist,
        "samples_per_cell_azim": schedule.num_samples,
        "samples_per_s": samples_per_s,
        "hori_mean_deg": float(np.rad2deg(hori_mean)),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi_name_power_limit": smi.splitlines()[0],
        "jax_version": jax.__version__,
        "compile_cache_dir": cache,
    }

    if args.trace:
        # a run of its own: one warm sweep and one warm pipeline call under
        # the profiler, no other row
        sweep_dir = os.path.join(args.trace, "sweep")
        with jax.profiler.trace(sweep_dir):
            jax.block_until_ready(run_sweep())
        top, busy, window = top_device_ops(sweep_dir)
        result["trace_top_device_ops"] = top
        result["trace_device_busy_ns"] = busy
        result["trace_device_window_ns"] = window
        result.update(trace_pipeline(
            os.path.join(args.trace, "pipeline"), z, dx, args.halo,
            (in0, in1), args.dist, args.azim, args.acc, args.iters))
        print(json.dumps(result))
        return

    # The public entry point (vertex buffer in, host horizon field out)
    xs = np.arange(w, dtype=np.float32) * dx
    ys = -np.arange(h, dtype=np.float32) * dx
    xx, yy = np.meshgrid(xs, ys)
    vert_grid = auxiliary.rearrange_pad_buffer(xx, yy, z)
    vec_norm = np.zeros((in0, in1, 3), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((in0, in1, 3), np.float32)
    vec_north[..., 1] = 1.0

    def run_gridded():
        return horizon.horizon_gridded(
            vert_grid, h, w, vec_norm, vec_north, args.halo, args.halo,
            args.dist, azim_num=args.azim, hori_acc=args.acc,
            verbose=False)[0]

    dt_gridded, _ = best_time(run_gridded, args.iters)
    result["horizon_gridded_wall_time_s"] = dt_gridded

    # Shadow: a 16-position sun track through the public Terrain API (one
    # sun position = one ray per cell in the reference, shadow_comp.cpp:
    # 386-491)
    n_sun = 16
    tt = np.linspace(0.15, 2.9, n_sun)
    cx, cy = 0.5 * (w - 1) * dx, -0.5 * (h - 1) * dx
    suns = np.stack([cx + 3.0e5 * np.cos(tt), cy + 3.0e5 * np.sin(tt),
                     2.0e4 + 1.0e4 * np.sin(2 * tt)],
                    axis=-1).astype(np.float32)
    terrain = shadow.Terrain()
    terrain.initialise(vert_grid, h, w, args.halo, args.halo, vec_norm,
                       vec_norm, np.ones((in0, in1), np.float32),
                       z[args.halo:args.halo + in0,
                         args.halo:args.halo + in1],
                       np.ones((in0, in1), np.uint8))
    dt_sh, _ = best_time(lambda: terrain.sw_dir_cor_batch(suns), args.iters)
    result["shadow_s_per_sun_position"] = dt_sh / n_sun
    result["shadow_rays_per_s"] = cells * n_sun / dt_sh

    if args.cpu_baseline:
        # Measured CPU baseline 1: the native multithreaded ray-marcher
        # (horayzon_tpu/native/fastdem.cpp) running the same dense bilinear
        # march on a subgrid; the samples/s ratio is the identical-work
        # hardware speedup.
        from horayzon_tpu.native import bvhbase, fastdem
        sub = min(64, in0, in1)
        t0 = time.perf_counter()
        _, cpu_samples = fastdem.horizon_march(
            z, dx, -dx, (args.halo, args.halo), (sub, sub), azim, dist_m)
        cpu_samples_per_s = cpu_samples / (time.perf_counter() - t0)
        result["cpu_samples_per_s"] = cpu_samples_per_s
        result["speedup_vs_cpu_same_algorithm"] = (samples_per_s
                                                   / cpu_samples_per_s)
        # Measured CPU baseline 2: the reference's algorithm — BVH
        # occlusion rays with the warm-started elevation search
        # (native/bvhbase.cpp) — on a subdomain, extrapolated by ray count
        # to the full bench domain (BASELINE.md methodology).
        _, n_rays, build_s, trace_s = bvhbase.horizon_rays(
            z, dx, -dx, (args.halo, args.halo), (sub, sub), args.azim,
            dist_m, hori_acc=args.acc)
        bvh_rays_per_s = n_rays / trace_s
        rpca = n_rays / (sub * sub * args.azim)
        t_cpu_full = (rpca * cells * args.azim) / bvh_rays_per_s
        result["bvh_cpu_rays_per_s"] = bvh_rays_per_s
        result["bvh_rays_per_cell_azim"] = rpca
        result["bvh_build_s"] = build_s
        result["vs_measured_bvh_cpu"] = t_cpu_full / dt

    print(json.dumps(result))


if __name__ == "__main__":
    main()

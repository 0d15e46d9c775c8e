# Copyright (c) 2026
# MIT License
"""Structured timing and throughput instrumentation.

The reference instruments itself with wall-clock printfs (BVH build time
horizon_comp.cpp:225-227, ray-tracing time :802-805, rays shot and mean
rays/(cell,azimuth) :807-810).  This module provides the equivalent as
structured records plus ``jax.profiler`` trace hooks.
"""

import contextlib
import dataclasses
import json
import os
import time

import jax


def sync(x):
    """Wait until every device array in ``x`` is computed."""
    return jax.block_until_ready(x)


def use_compile_cache(default_dir):
    """Keep JAX's persistent compilation cache in ``JAX_COMPILATION_CACHE_DIR``
    when that is set, else in ``default_dir``; returns the directory used.

    For entry scripts: the library itself configures no cache."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or default_dir
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclasses.dataclass
class SweepStats:
    """Throughput record for one horizon/shadow sweep."""
    wall_time_s: float
    cells: int
    azim_num: int
    samples_per_cell_azim: int

    @property
    def samples_per_s(self):
        return self.cells * self.azim_num * self.samples_per_cell_azim \
            / self.wall_time_s

    @property
    def rays_per_s_equivalent(self):
        """Reference-equivalent rays/s (the reference shoots ~2 rays per
        (cell, azimuth) with guess_constant, horizon_comp.cpp:807-810)."""
        return self.cells * self.azim_num * 2.0 / self.wall_time_s

    def to_json(self):
        return json.dumps({
            "wall_time_s": self.wall_time_s,
            "cells": self.cells,
            "azim_num": self.azim_num,
            "samples_per_cell_azim": self.samples_per_cell_azim,
            "samples_per_s": self.samples_per_s,
            "rays_per_s_equivalent": self.rays_per_s_equivalent,
        })


@contextlib.contextmanager
def timed(label="", result_holder=None):
    """Context manager timing a device computation (callers must sync)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder.append(dt)
    if label:
        print(f"{label}: {dt:.3f} s")


def time_sweep(fn, cells, azim_num, samples_per_cell_azim, iters=3):
    """Time ``fn`` (returning a device array) and build a SweepStats."""
    sync(fn())   # warm-up / compile
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn())
        best = min(best, time.perf_counter() - t0)
    return SweepStats(wall_time_s=best, cells=cells, azim_num=azim_num,
                      samples_per_cell_azim=samples_per_cell_azim)


@contextlib.contextmanager
def profiler_trace(log_dir):
    """jax.profiler trace around a block (view in TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

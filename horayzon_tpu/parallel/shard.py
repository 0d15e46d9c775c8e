# Copyright (c) 2026
# MIT License
"""Sharded horizon/shadow sweeps over a device mesh.

TBB work distribution over grid rows (reference horizon_comp.cpp:739-800)
becomes ``shard_map`` over a (tile, azim) mesh: the outer heightfield is
replicated (each shard needs terrain out to ``dist_search`` beyond its rows,
which for typical search distances is a large fraction of the domain), the
inner-domain rows are sharded along ``tile`` and the azimuth axis along
``azim``.  Results assemble with no communication beyond output layout; the
backward pass (gradients w.r.t. the shared heightfield) psums automatically
through the ``shard_map`` transpose.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from horayzon_tpu.ops import sweep as _sweep
from horayzon_tpu.parallel import mesh as _mesh

try:  # JAX >= 0.4.35 exposes shard_map at the top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def horizon_sweep_sharded(mesh, z_outer, *, dx, dy, offset, inner_shape,
                          azim, dist_search, hori_acc=0.25,
                          elev_ang_low_lim=-15.0, elev_ang_up_lim=89.98,
                          ray_org_elev=0.01, geom=None, u_xy=None,
                          rel_err=None):
    """Multi-device horizon sweep; same contract as
    :func:`horayzon_tpu.ops.sweep.horizon_sweep`.

    Requirements: ``inner_shape[0]`` divisible by the mesh's tile axis and
    ``len(azim)`` divisible by its azim axis.
    """
    n_tile = mesh.shape[_mesh.AXIS_TILE]
    n_azim = mesh.shape[_mesh.AXIS_AZIM]
    in0, in1 = inner_shape
    a_num = len(azim)
    if in0 % n_tile != 0:
        raise ValueError(f"inner rows {in0} not divisible by tile axis "
                         f"{n_tile}")
    if a_num % n_azim != 0:
        raise ValueError(f"azimuth count {a_num} not divisible by azim axis "
                         f"{n_azim}")
    rows = in0 // n_tile

    z_outer = jnp.asarray(z_outer, dtype=jnp.float32)
    step = min(abs(dx), abs(dy))
    if rel_err is None:
        rel_err = _sweep.default_rel_err(hori_acc)
    schedule = _sweep.build_schedule(step, dist_search * 1.0, rel_err)
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
    off0, off1 = offset
    z_inner = jax.lax.dynamic_slice(z_outer, (off0, off1), (in0, in1))
    planar = geom is None
    if planar:
        z_org = z_inner + jnp.float32(ray_org_elev)
        geom_in = {}
    else:
        geom_in = {k: jnp.asarray(v, dtype=jnp.float32)
                   for k, v in geom.items()}
        z_org = z_inner + jnp.float32(ray_org_elev) * geom_in["mz"]

    sched_meta = schedule.meta()
    pads = schedule.pads

    # Per-shard: shift row-slice starts by the tile's first row.
    def shard_fn(z_outer_rep, z_org_sh, geom_sh, tables_sh, trig_sh):
        tile_idx = jax.lax.axis_index(_mesh.AXIS_TILE)
        row0 = tile_idx * rows
        # Tile-sharded fields combine with azim-sharded tables inside the
        # sweep's scans; mark them varying over the azim axis too so the
        # scan carry types line up.
        z_outer_rep = jax.lax.pcast(
            z_outer_rep, (_mesh.AXIS_TILE, _mesh.AXIS_AZIM), to="varying")
        z_org_sh = jax.lax.pcast(z_org_sh, (_mesh.AXIS_AZIM,), to="varying")
        geom_sh = jax.tree_util.tree_map(
            lambda a: jax.lax.pcast(a, (_mesh.AXIS_AZIM,), to="varying"),
            geom_sh)
        adj = []
        for p, (kind, level, pad, *_rest) in enumerate(sched_meta):
            t = dict(tables_sh[f"p{p}"])
            if kind == "d2":
                t["m_i0"] = t["m_i0"] + row0
                t["e_i0"] = t["e_i0"] + row0
            elif kind == "d1":
                t["i0"] = t["i0"] + row0
            else:
                k = 2 ** level
                ci = (t["base_i"] - pad) * k + t["r_i"] + row0
                t["base_i"] = jnp.floor_divide(ci, k) + pad
                t["r_i"] = jnp.mod(ci, k)
            adj.append(t)
        z_inner_sh = (z_org_sh - ray_org_elev if planar
                      else z_org_sh - ray_org_elev * geom_sh["mz"])
        hori, _ = _sweep.horizon_core_fn(
            z_outer_rep, z_org_sh, z_inner_sh,
            geom_sh if not planar else None,
            adj, trig_sh,
            sched_meta=sched_meta, pads=pads,
            inner_shape=(rows, in1), planar=planar, track_dist=False)
        return hori

    tables_named = {f"p{p}": t for p, t in enumerate(tables)}

    table_specs = jax.tree_util.tree_map(
        lambda _: P(_mesh.AXIS_AZIM, None, None), tables_named)
    trig_specs = jax.tree_util.tree_map(lambda _: P(_mesh.AXIS_AZIM), trig)
    geom_specs = jax.tree_util.tree_map(
        lambda _: P(_mesh.AXIS_TILE, None), geom_in)

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, None), P(_mesh.AXIS_TILE, None), geom_specs,
                  table_specs, trig_specs),
        out_specs=P(_mesh.AXIS_TILE, None, _mesh.AXIS_AZIM))
    hori = jax.jit(fn)(z_outer, z_org, geom_in, tables_named, trig)
    lo = math.radians(elev_ang_low_lim)
    hi = math.radians(elev_ang_up_lim)
    return jnp.clip(hori, lo, hi)


def shadow_metric_sharded(mesh, z_outer, z_org, z_inner, m_slope, u_cells,
                          schedule, offset, inner_shape):
    """Multi-device shadow occlusion metric (rows sharded over 'tile').

    Same contract as :func:`horayzon_tpu.ops.sweep.shadow_metric`; the sun
    direction/slope may be traced (per-timestep).  The azim mesh axis, if
    present, is unused (replicated work)."""
    n_tile = mesh.shape[_mesh.AXIS_TILE]
    in0, in1 = inner_shape
    if in0 % n_tile != 0:
        raise ValueError(f"inner rows {in0} not divisible by tile axis "
                         f"{n_tile}")
    rows = in0 // n_tile
    s_phases = tuple(
        jnp.asarray(_sweep._pad_unroll(s[None, :], _sweep.UNROLL)[0])
        for s in schedule.s_values)
    sched_meta = schedule.meta()
    pads = schedule.pads

    def shard_fn(z_rep, z_org_sh, z_inner_sh, m_sh, u_c, phases):
        row0 = jax.lax.axis_index(_mesh.AXIS_TILE) * rows
        return _sweep.shadow_metric_core_fn(
            z_rep, z_org_sh, z_inner_sh, m_sh, u_c, phases,
            sched_meta=sched_meta, pads=pads,
            offset=(int(offset[0]), int(offset[1])),
            inner_shape=(rows, in1), row_shift=row0)

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, None), P(_mesh.AXIS_TILE, None),
                  P(_mesh.AXIS_TILE, None), P(_mesh.AXIS_TILE, None),
                  P(None), jax.tree_util.tree_map(lambda _: P(None, None),
                                                  s_phases)),
        out_specs=P(_mesh.AXIS_TILE, None))
    return jax.jit(fn)(
        jnp.asarray(z_outer, jnp.float32), jnp.asarray(z_org, jnp.float32),
        jnp.asarray(z_inner, jnp.float32),
        jnp.asarray(m_slope, jnp.float32),
        jnp.asarray(u_cells, jnp.float32), s_phases)

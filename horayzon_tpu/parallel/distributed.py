# Copyright (c) 2026
# MIT License
"""Multi-host initialisation and mesh construction.

The reference parallelises within one shared-memory node (TBB
``parallel_reduce`` over grid rows, horizon_comp.cpp:739-800) and has no
cross-node story.  Here the same (tile, azim) mesh extends over processes:
JAX's distributed runtime connects them, and the mesh is laid out so
consecutive *tile* (grid-row) shards live in the same process.  The only
cross-shard communication is the output gather and the gradient psum.

Two-process recipe (one process per host; the coordinator address is
mandatory, nothing detects a cluster automatically)::

    # process 0
    HZT_COORDINATOR=10.0.0.1:8476 HZT_NUM_PROCESSES=2 HZT_PROCESS_ID=0 \
        python train_or_sweep.py
    # process 1
    HZT_COORDINATOR=10.0.0.1:8476 HZT_NUM_PROCESSES=2 HZT_PROCESS_ID=1 \
        python train_or_sweep.py

where the script calls::

    from horayzon_tpu import parallel
    mesh = parallel.distributed.init_distributed(n_azim=4)
    hori = parallel.shard.horizon_sweep_sharded(mesh, z, ...)
"""

import os

import jax

from horayzon_tpu.parallel import mesh as _mesh


def init_distributed(n_tile=None, n_azim=1, *, coordinator_address=None,
                     num_processes=None, process_id=None,
                     local_device_ids=None):
    """Initialise the JAX distributed runtime (if needed) and build the
    global (tile, azim) mesh.

    Parameters
    ----------
    n_tile, n_azim : mesh shape over *global* devices (``n_tile`` defaults
        to ``len(jax.devices()) // n_azim``).
    coordinator_address, num_processes, process_id : explicit multi-host
        wiring; default to the ``HZT_COORDINATOR`` / ``HZT_NUM_PROCESSES``
        / ``HZT_PROCESS_ID`` environment variables.
    local_device_ids : optional restriction of this process's devices.

    Returns
    -------
    jax.sharding.Mesh over all global devices, ordered so consecutive
    ``tile`` rows live on the same host (row-major over processes).

    Single-process use (tests, one host) needs no configuration: if no
    coordinator is known and only one process exists, the distributed
    runtime is left untouched.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "HZT_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("HZT_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("HZT_PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    already = jax.distributed.is_initialized()
    explicit = bool(coordinator_address or num_processes)
    if not already and explicit:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
    return _mesh.make_mesh(n_tile=n_tile, n_azim=n_azim,
                           devices=jax.devices())

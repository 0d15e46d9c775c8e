# Copyright (c) 2026
# MIT License
"""Executed multi-process test of the distributed backend.

SURVEY.md section 5 ("Distributed communication backend"): the reference
has no multi-host story; ours is ``parallel.distributed.init_distributed``
wiring ``jax.distributed`` + the (tile, azim) mesh.  This test actually
RUNS it with two OS processes on CPU (loopback coordinator, 4 virtual
devices each -> 8 global), executes the sharded sweep across both, and
asserts each process's addressable output shards equal the
single-device result.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os
import sys

# XLA_FLAGS is read lazily at first backend init; the platform choice
# also goes through jax.config.update in case jax is already imported
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
port = sys.argv[2]

from horayzon_tpu import parallel
from horayzon_tpu.ops import sweep

mesh = parallel.distributed.init_distributed(
    n_azim=2, coordinator_address=f"127.0.0.1:{port}",
    num_processes=2, process_id=pid)
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4

# deterministic synthetic terrain (all processes build the same array)
rng = np.random.default_rng(3)
n = 96
yy, xx = np.mgrid[0:n, 0:n]
z = np.zeros((n, n))
for _ in range(8):
    cy, cx = rng.uniform(0, n), rng.uniform(0, n)
    sig = rng.uniform(4.0, 16.0)
    z += rng.uniform(50, 300) * np.exp(
        -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
z = z.astype(np.float32)

kw = dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(32, 32),
          azim=(2 * np.pi / 4) * np.arange(4), dist_search=700.0,
          hori_acc=0.25)
from horayzon_tpu.parallel import shard as pshard
out = pshard.horizon_sweep_sharded(mesh, z, **kw)

ref = np.asarray(sweep.horizon_sweep(z, **kw)[0])

# each process checks the shards it holds against the single-device run
checked = 0
for sh in out.addressable_shards:
    idx = sh.index
    np.testing.assert_allclose(np.asarray(sh.data), ref[idx], atol=1e-5)
    checked += 1
assert checked > 0
print(f"proc {pid}: {checked} shards match single-device", flush=True)
print(f"proc {pid}: DISTRIBUTED-OK", flush=True)
"""


def test_two_process_cpu_distributed(tmp_path):
    """Two real OS processes, one JAX coordination service, sharded
    sweep across both == single-device (executed multi-process
    evidence)."""
    worker = tmp_path / "dist_worker.py"
    worker.write_text(_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # drop any inherited single-process distributed config
    for k in ("HZT_COORDINATOR", "HZT_NUM_PROCESSES", "HZT_PROCESS_ID"):
        env.pop(k, None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-30:])
        assert p.returncode == 0, f"proc {i} rc={p.returncode}\n{tail}"
        assert f"proc {i}: DISTRIBUTED-OK" in out, f"proc {i}\n{tail}"

import jax
import numpy as np
import pytest

from horayzon_tpu.ops import sweep
from horayzon_tpu.parallel import mesh as pmesh
from horayzon_tpu.parallel import shard as pshard

from reference_impl import gaussian_bumps_terrain


@pytest.fixture(scope="module")
def terrain():
    z = gaussian_bumps_terrain(64, 64, seed=7, amp=400.0)
    return z


def _single_device(z, azim, **kw):
    hori, _ = sweep.horizon_sweep(z, **kw, azim=azim)
    return np.asarray(hori)


def test_sharded_matches_single_device(terrain):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    azim = (2 * np.pi / 16) * np.arange(16)
    kw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(32, 32),
              dist_search=600.0, hori_acc=0.25)
    ref = _single_device(terrain, azim, **kw)

    mesh = pmesh.make_mesh(n_tile=4, n_azim=2)
    out = pshard.horizon_sweep_sharded(mesh, terrain, **kw, azim=azim)
    out = np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("n_tile,n_azim", [(8, 1), (2, 4), (1, 8), (2, 2)])
def test_sharded_mesh_shapes(terrain, n_tile, n_azim):
    """Equality across (n_tile, n_azim) mesh shapes — the virtual stand-in
    for multi-host layouts where the tile axis spans hosts."""
    if len(jax.devices()) < n_tile * n_azim:
        pytest.skip("needs enough virtual devices")
    azim = (2 * np.pi / 8) * np.arange(8)
    kw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(32, 32),
              dist_search=500.0)
    ref = _single_device(terrain, azim, **kw)
    mesh = pmesh.make_mesh(
        n_tile=n_tile, n_azim=n_azim,
        devices=jax.devices()[:n_tile * n_azim])
    out = np.asarray(pshard.horizon_sweep_sharded(mesh, terrain, **kw,
                                                  azim=azim))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_init_distributed_single_process(terrain):
    """init_distributed with no cluster config is a pure mesh builder."""
    from horayzon_tpu import parallel

    n_dev = len(jax.devices())
    if n_dev < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = parallel.init_distributed(n_azim=2)
    assert mesh.devices.shape == (n_dev // 2, 2)
    azim = (2 * np.pi / 4) * np.arange(4)
    kw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(32, 32),
              dist_search=500.0)
    ref = _single_device(terrain, azim, **kw)
    out = np.asarray(pshard.horizon_sweep_sharded(mesh, terrain, **kw,
                                                  azim=azim))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_sharded_gradients_flow(terrain):
    """Differentiability through the sharded sweep: gradients w.r.t. the
    replicated heightfield psum across shards."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    azim = (2 * np.pi / 8) * np.arange(8)
    mesh = pmesh.make_mesh(n_tile=4, n_azim=2)

    import jax.numpy as jnp

    def loss(z):
        hori = pshard.horizon_sweep_sharded(
            mesh, z, dx=25.0, dy=-25.0, offset=(16, 16),
            inner_shape=(32, 32), dist_search=500.0, azim=azim)
        return jnp.mean(hori)

    g = jax.grad(loss)(jnp.asarray(terrain))
    g = np.asarray(g)
    assert g.shape == terrain.shape
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0


def test_sharded_shadow_matches_single_device(terrain):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from horayzon_tpu.ops import sweep as _sweep

    dx = 25.0
    off = (16, 16)
    inner = (32, 32)
    z_in = terrain[16:48, 16:48]
    z_org = z_in + 0.05
    m = np.full(inner, 0.2, np.float32)
    u_cells = np.array([0.0, 1.0 / dx], dtype=np.float32)
    diag = np.hypot(64 * dx, 64 * dx)
    sched = _sweep.build_schedule(dx, diag, _sweep.default_rel_err(0.25))
    ref = np.asarray(_sweep.shadow_metric(
        terrain, z_org, z_in, m, u_cells, sched, off, inner))
    mesh = pmesh.make_mesh(n_tile=8, n_azim=1)
    out = np.asarray(pshard.shadow_metric_sharded(
        mesh, terrain, z_org, z_in, m, u_cells, sched, off, inner))
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("n_tile,n_azim", [(8, 1), (4, 2)])
def test_sharded_shadow_gradients(terrain, n_tile, n_azim):
    """jax.grad through the row-sharded shadow metric equals the
    single-device gradient, w.r.t. both the replicated heightfield (psum
    over the tile axis) and the sharded ray-origin field."""
    if len(jax.devices()) < n_tile * n_azim:
        pytest.skip("needs enough virtual devices")
    import jax.numpy as jnp

    dx = 25.0
    off = (16, 16)
    inner = (32, 32)
    u_cells = np.array([0.3 / -dx, 0.95 / dx], dtype=np.float32)
    diag = np.hypot(64 * dx, 64 * dx)
    sched = sweep.build_schedule(dx, diag, sweep.default_rel_err(0.25))
    m = np.full(inner, 0.12, np.float32)
    mesh = pmesh.make_mesh(n_tile=n_tile, n_azim=n_azim,
                           devices=jax.devices()[:n_tile * n_azim])

    def loss(metric_fn, zz, zorg):
        z_i = jax.lax.dynamic_slice(zz, off, inner)
        met = metric_fn(zz, zorg, z_i, m, u_cells, sched, off, inner)
        return jnp.mean(jax.nn.sigmoid(met / 5.0))

    def single(*a):
        return sweep.shadow_metric(*a)

    def sharded(*a):
        return pshard.shadow_metric_sharded(mesh, *a)

    z = jnp.asarray(terrain)
    zorg = jax.lax.dynamic_slice(z, off, inner) + 0.05
    gz_s, go_s = jax.grad(lambda a, b: loss(single, a, b),
                          argnums=(0, 1))(z, zorg)
    gz_m, go_m = jax.grad(lambda a, b: loss(sharded, a, b),
                          argnums=(0, 1))(z, zorg)
    gmax = float(jnp.abs(gz_s).max())
    assert gmax > 0.0
    np.testing.assert_allclose(np.asarray(gz_m), np.asarray(gz_s),
                               rtol=1e-5, atol=1e-6 * gmax)
    np.testing.assert_allclose(np.asarray(go_m), np.asarray(go_s),
                               rtol=1e-5,
                               atol=1e-6 * float(jnp.abs(go_s).max()))

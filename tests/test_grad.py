import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horayzon_tpu.ops import sweep
from horayzon_tpu.topo_param import svf_core_fn

from reference_impl import gaussian_bumps_terrain


def _loss(z, azim, tilt):
    hori, _ = sweep.horizon_sweep(z, dx=25.0, dy=-25.0, offset=(16, 16),
                                  inner_shape=(16, 16), azim=azim,
                                  dist_search=400.0)
    svf = svf_core_fn(jnp.asarray(azim, jnp.float32), hori, tilt)
    return jnp.mean(svf)


def test_horizon_gradients_finite_and_nonzero():
    """The sweep is differentiable w.r.t. the DEM heightfield (BASELINE
    north star: gradients through the intersection tests)."""
    z = jnp.asarray(gaussian_bumps_terrain(48, 48, seed=8, amp=300.0))
    azim = (2 * np.pi / 8) * np.arange(8)
    tilt = jnp.zeros((16, 16, 3), jnp.float32).at[..., 2].set(1.0)
    g = jax.grad(_loss)(z, azim, tilt)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0
    # Physics: horizon angles are invariant under a uniform elevation
    # shift (terrain and observers rise together), so the gradient's
    # positive mass (raising observers clears their sky) exactly balances
    # the negative mass (raising terrain blocks it): sum(g) ~= 0.
    assert g.min() < 0.0 < g.max()
    assert abs(g.sum()) < 1e-3 * np.abs(g).sum()


def test_gradient_matches_finite_difference():
    """Directional derivative vs central finite difference."""
    z0 = jnp.asarray(gaussian_bumps_terrain(48, 48, seed=9, amp=200.0))
    azim = (2 * np.pi / 4) * np.arange(4)
    tilt = jnp.zeros((16, 16, 3), jnp.float32).at[..., 2].set(1.0)

    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal(z0.shape).astype(np.float32))
    g = jax.grad(_loss)(z0, azim, tilt)
    directional = float(jnp.vdot(g, v))
    eps = 0.05
    lp = float(_loss(z0 + eps * v, azim, tilt))
    lm = float(_loss(z0 - eps * v, azim, tilt))
    fd = (lp - lm) / (2 * eps)
    # The forward has kinks (max, clip); agreement is approximate
    assert np.isfinite(directional) and np.isfinite(fd)
    assert abs(directional - fd) < 0.3 * (abs(fd) + abs(directional)) + 1e-4


def _make_terrain_obj(z, in0=24, in1=24, off=12):
    """Planar Terrain over a synthetic DEM (vert_grid convention)."""
    from horayzon_tpu import auxiliary, shadow

    h, w = z.shape
    dx = 25.0
    x = np.arange(w, dtype=np.float32) * dx
    y = -np.arange(h, dtype=np.float32) * dx
    xx, yy = np.meshgrid(x, y)
    vert_grid = auxiliary.rearrange_pad_buffer(xx, yy, z)
    vec = np.zeros((in0, in1, 3), np.float32)
    vec[..., 2] = 1.0
    t = shadow.Terrain()
    t.initialise(vert_grid, h, w, off, off, vec, vec,
                 np.ones((in0, in1), np.float32),
                 z[off:off + in0, off:off + in1],
                 np.ones((in0, in1), np.uint8))
    return t


def test_sw_dir_cor_soft_matches_hard_forward():
    """straight_through soft occlusion must not change hard values
    (shadow_comp.cpp:561-596 semantics kept)."""
    z = gaussian_bumps_terrain(48, 48, seed=3, amp=250.0)
    t = _make_terrain_obj(z)
    sun = np.array([3.0e5, -2.0e5, 2.0e4], np.float32)
    hard = t.sw_dir_cor(sun)
    soft_st = np.asarray(t.sw_dir_cor_soft(sun, soft_tau=2.0,
                                           straight_through=True))
    np.testing.assert_array_equal(soft_st, hard)
    # batch form
    suns = np.stack([sun, sun * np.array([-1.0, 1.0, 1.0], np.float32)])
    hard_b = t.sw_dir_cor_batch(suns)
    soft_b = np.asarray(t.sw_dir_cor_soft(suns, soft_tau=2.0))
    np.testing.assert_array_equal(soft_b, hard_b)


def test_sw_dir_cor_soft_gradient_finite_difference():
    """d mean(soft sw_dir_cor) / d elevation vs central finite difference
    of the softened loss (SURVEY.md section 7 step 8)."""
    z = gaussian_bumps_terrain(48, 48, seed=5, amp=250.0)
    t = _make_terrain_obj(z)
    sun = jnp.asarray([3.0e5, -2.0e5, 1.5e4], jnp.float32)

    def loss(zz):
        out = t.sw_dir_cor_soft(sun, elevation=zz, soft_tau=8.0,
                                straight_through=False)
        return jnp.mean(out)

    z0 = jnp.asarray(z)
    g = jax.grad(loss)(z0)
    g_np = np.asarray(g)
    assert np.isfinite(g_np).all() and np.abs(g_np).max() > 0.0
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.standard_normal(z.shape).astype(np.float32))
    directional = float(jnp.vdot(g, v))
    eps = 0.05
    fd = (float(loss(z0 + eps * v)) - float(loss(z0 - eps * v))) / (2 * eps)
    assert abs(directional - fd) < 0.05 * (abs(fd) + abs(directional)) + 1e-6


def _fd_case(case):
    """(loss, args, probes) for one gradient check: ``probes`` is a list of
    (argnum, direction) pairs to compare by central differences; a
    direction of None probes the three cells with the largest gradient.
    Horizons are unclipped (low limit -89.98 deg) and terrains carry a
    gentle ramp, so that no probe straddles the clip's kink or a tie
    between max-pooled neighbours of a flat area."""
    from horayzon_tpu import terrain as _terrain
    from horayzon_tpu.ops import multires

    from reference_impl import tilted_vectors

    def ramped(z):
        ii, jj = np.mgrid[0:z.shape[0], 0:z.shape[1]]
        return (z + 0.4 * ii + 0.25 * jj).astype(np.float32)

    rng = np.random.default_rng(17)
    dx = 25.0
    if case in ("near_field", "general"):
        z = jnp.asarray(ramped(gaussian_bumps_terrain(48, 48, seed=4,
                                                      amp=300.0)))
        azim = (2 * np.pi / 8) * np.arange(8)
        kw = dict(dx=dx, dy=-dx, offset=(16, 16), inner_shape=(16, 16),
                  azim=azim, dist_search=150.0 if case == "near_field"
                  else 350.0, elev_ang_low_lim=-89.98)
        if case == "general":
            vn, vno = tilted_vectors((16, 16), 6.0)
            kw.update(geom=_terrain.basis_fields(vn, vno),
                      u_xy=_terrain.mean_marching_directions(azim, vn, vno))

        def loss(zz):
            return jnp.mean(sweep.horizon_sweep(zz, **kw)[0] ** 2)

        return loss, (z,), [(0, None)]
    if case == "far_field":
        # isolated spikes beyond the dense range: their winners come from
        # the max-mip far field (the gradient reaches the pooled block's
        # maximum cell)
        dist = 6000.0
        halo = int(dist / dx) + 16
        n = 16 + 2 * halo
        z = np.zeros((n, n), np.float32)
        z[halo - 96, halo + 8] = 500.0
        z[halo - 150, halo + 4] = 400.0
        kw = dict(dx=dx, dy=-dx, offset=(halo, halo), inner_shape=(16, 16),
                  azim=(2 * np.pi / 4) * np.arange(4), dist_search=dist)

        def loss(zz):
            return jnp.mean(sweep.horizon_sweep(zz, **kw)[0] ** 2)

        e = jnp.zeros((n, n), jnp.float32).at[halo - 96, halo + 8].set(1.0)
        return loss, (jnp.asarray(z),), [(0, e)]
    if case in ("multires_fine", "multires_coarse"):
        dist, acc, r_log2, inner, halo_fine = 4000.0, 2.0, 2, 16, 96
        halo_full = int(dist / dx) + 16
        n_full = inner + 2 * halo_full
        full = ramped(gaussian_bumps_terrain(n_full, n_full, seed=9,
                                             amp=500.0))
        i0 = halo_full - halo_fine
        z_fine = jnp.asarray(full[i0:i0 + inner + 2 * halo_fine,
                                  i0:i0 + inner + 2 * halo_fine])
        r = 2 ** r_log2
        hc = n_full - n_full % r
        coarse = full[:hc, :hc].reshape(hc // r, r, hc // r, r) \
            .max(axis=(1, 3))
        # isolated ridge ~3 km north, outside the 2.4 km fine halo: only
        # the coarse far field sees it
        ri = (halo_full - 120) // r
        rj = (halo_full + 8) // r
        coarse[ri, rj - 2:rj + 3] += 900.0
        z_coarse = jnp.asarray(coarse)
        kw = dict(ratio_log2=r_log2, coarse_offset=(i0, i0), dx=dx, dy=-dx,
                  offset=(halo_fine, halo_fine), inner_shape=(inner, inner),
                  azim=(2 * np.pi / 4) * np.arange(4), dist_search=dist,
                  hori_acc=acc, elev_ang_low_lim=-89.98)

        def loss(zf, zc):
            return jnp.mean(multires.horizon_sweep_multires(zf, zc, **kw)
                            ** 2)

        if case == "multires_fine":
            # a broad bump: it keeps the order of max-pooled neighbours,
            # which single-cell probes of the pooled levels can flip
            c = halo_fine + inner // 2
            ii, jj = np.mgrid[0:z_fine.shape[0], 0:z_fine.shape[1]]
            bump = np.exp(-((ii - c) ** 2 + (jj - c) ** 2) / (2 * 12.0 ** 2))
            return loss, (z_fine, z_coarse), [(0, jnp.asarray(
                bump.astype(np.float32)))]
        e = jnp.zeros(z_coarse.shape, jnp.float32).at[ri, rj].set(1.0)
        return loss, (z_fine, z_coarse), [(1, e)]
    assert case == "soft_sw_dir_cor_batch"
    z = gaussian_bumps_terrain(48, 48, seed=5, amp=250.0)
    t = _make_terrain_obj(z)
    suns = jnp.asarray([[3.0e5, -2.0e5, 1.5e4], [-2.5e5, 1.0e5, 2.0e4]],
                       jnp.float32)

    def loss(zz):
        return jnp.mean(t.sw_dir_cor_soft(suns, elevation=zz, soft_tau=8.0,
                                          straight_through=False))

    v = jnp.asarray(rng.standard_normal(z.shape).astype(np.float32))
    return loss, (jnp.asarray(z),), [(0, v)]


@pytest.mark.parametrize("case", [
    "near_field", "far_field", "general", "multires_fine",
    "multires_coarse", "soft_sw_dir_cor_batch"])
def test_gradient_finite_difference_cases(case):
    """Autodiff through the XLA sweep vs central finite differences of the
    same loss, at single cells or along a random direction (the soft,
    sigmoid-smoothed shadow loss).  Tolerance: 5 % relative."""
    loss, args, probes = _fd_case(case)
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    for g in grads:
        assert np.isfinite(np.asarray(g)).all()
    cells = []
    for argnum, d in probes:
        if d is not None:
            cells.append((argnum, d))
            continue
        g = np.asarray(grads[argnum])
        for idx in np.argsort(-np.abs(g).ravel())[:3]:
            e = np.zeros(g.shape, np.float32)
            e[np.unravel_index(idx, g.shape)] = 1.0
            cells.append((argnum, jnp.asarray(e)))
    for argnum, d in cells:
        g = grads[argnum]
        an = float(jnp.vdot(g, d))
        assert an != 0.0, "no gradient along the probe"
        # large enough that the float32 loss resolves the change
        eps = {"far_field": 0.5, "multires_coarse": 0.5,
               "multires_fine": 0.5,
               "soft_sw_dir_cor_batch": 0.05}.get(case, 0.01)

        def shifted(sign):
            a = list(args)
            a[argnum] = a[argnum] + sign * eps * d
            return float(loss(*a))

        fd = (shifted(1.0) - shifted(-1.0)) / (2 * eps)
        assert abs(an - fd) < 0.05 * (abs(fd) + abs(an)), (an, fd)

import numpy as np
import pytest

from horayzon_tpu import auxiliary, horizon
from horayzon_tpu.ops import sweep

from reference_impl import brute_horizon, gaussian_bumps_terrain


def _vert_grid_planar(z, dx=25.0, dy=-25.0, x0=0.0, y0=0.0):
    h, w = z.shape
    x1 = x0 + np.arange(w, dtype=np.float32) * dx
    y1 = y0 + np.arange(h, dtype=np.float32) * dy
    x, y = np.meshgrid(x1, y1)
    return auxiliary.rearrange_pad_buffer(x.astype(np.float32),
                                          y.astype(np.float32),
                                          z.astype(np.float32))


def _default_vectors(in0, in1):
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_north[..., 1] = 1.0
    return vec_norm, vec_north


def test_flat_plane_horizon_zero():
    z = np.zeros((64, 64), dtype=np.float32)
    vg = _vert_grid_planar(z)
    vn, vnor = _default_vectors(32, 32)
    hori, azim = horizon.horizon_gridded(
        vg, 64, 64, vn, vnor, 16, 16, dist_search=0.5, azim_num=16,
        verbose=False)
    assert hori.shape == (32, 32, 16)
    assert np.abs(hori).max() < np.deg2rad(0.05)
    assert np.allclose(azim, (2 * np.pi / 16) * np.arange(16))


def test_single_wall_horizon_angle():
    # Wall of height 100 m, 500 m north of the observer row
    dx = 25.0
    z = np.zeros((64, 64), dtype=np.float32)
    z[10, :] = 100.0  # row 10; dy = -25 -> north of rows > 10
    vg = _vert_grid_planar(z, dx=dx, dy=-dx)
    vn, vnor = _default_vectors(1, 1)
    # observer at row 30, col 32: distance to wall = (30-10)*25 = 500 m
    hori, azim = horizon.horizon_gridded(
        vg, 64, 64, vn, vnor, 30, 32, dist_search=1.5, azim_num=4,
        verbose=False)
    # azim[0] = 0 = north -> horizon = atan(100/500)
    expect = np.arctan(100.0 / 500.0)
    assert np.isclose(hori[0, 0, 0], expect, atol=np.deg2rad(0.6))
    # south (azim index 2) -> flat
    assert abs(hori[0, 0, 2]) < np.deg2rad(0.1)


def test_horizon_vs_bruteforce_random_terrain():
    dx = 25.0
    z = gaussian_bumps_terrain(48, 48, seed=3, amp=300.0)
    vg = _vert_grid_planar(z, dx=dx, dy=-dx)
    in0 = in1 = 12
    off = 18
    vn, vnor = _default_vectors(in0, in1)
    azim_num = 8
    hori, azim = horizon.horizon_gridded(
        vg, 48, 48, vn, vnor, off, off, dist_search=1.0,
        azim_num=azim_num, hori_acc=0.25, verbose=False)
    oracle = brute_horizon(z, dx, -dx, (off, off), (in0, in1), azim,
                           1000.0, step_frac=0.25)
    err = np.rad2deg(np.abs(hori - oracle))
    assert err.max() < 0.5, f"max horizon error {err.max():.3f} deg"


def test_horizon_mask_fill():
    z = np.zeros((32, 32), dtype=np.float32)
    vg = _vert_grid_planar(z)
    vn, vnor = _default_vectors(8, 8)
    mask = np.ones((8, 8), dtype=np.uint8)
    mask[0, :] = 0
    hori, _ = horizon.horizon_gridded(
        vg, 32, 32, vn, vnor, 12, 12, dist_search=0.3, azim_num=4,
        mask=mask, hori_fill=0.77, verbose=False)
    assert np.allclose(hori[0, :, :], 0.77)
    assert np.abs(hori[1:, :, :]).max() < np.deg2rad(0.05)


def test_horizon_clamps_to_elev_limits():
    z = np.zeros((32, 32), dtype=np.float32)
    # Deep pit: observer far below surroundings is impossible on flat;
    # instead check the lower clamp on flat terrain with high elev_low
    vg = _vert_grid_planar(z)
    vn, vnor = _default_vectors(4, 4)
    hori, _ = horizon.horizon_gridded(
        vg, 32, 32, vn, vnor, 14, 14, dist_search=0.3, azim_num=4,
        elev_ang_low_lim=5.0, verbose=False)
    assert np.allclose(hori, np.deg2rad(5.0), atol=1e-6)


def test_invalid_args_raise():
    z = np.zeros((16, 16), dtype=np.float32)
    vg = _vert_grid_planar(z)
    vn, vnor = _default_vectors(4, 4)
    with pytest.raises(ValueError):
        horizon.horizon_gridded(vg, 16, 16, vn, vnor, 14, 14,
                                dist_search=0.2, verbose=False)  # offset
    with pytest.raises(ValueError):
        horizon.horizon_gridded(vg, 16, 16, vn, vnor, 6, 6,
                                dist_search=0.2, ray_algorithm="bogus",
                                verbose=False)
    with pytest.raises(ValueError):
        horizon.horizon_gridded(vg, 16, 16, vn, vnor, 6, 6,
                                dist_search=0.2, hori_acc=30.0,
                                verbose=False)
    with pytest.raises(TypeError):
        horizon.horizon_gridded(vg, 16, 16, vn, vnor, 6, 6,
                                dist_search=0.2, ray_org_elev=0.0,
                                verbose=False)


def test_schedule_structure():
    sched = sweep.build_schedule(25.0, 20000.0, rel_err=0.005)
    assert sched.phases[0].level == 0
    s_all = np.concatenate(sched.s_values)
    assert (np.diff(s_all) > 0).all()
    assert s_all[-1] <= 20000.0 + 1e-3
    assert s_all[-1] > 0.95 * 20000.0
    # number of samples stays manageable
    assert sched.num_samples < 2000


def test_schedule_short_distance():
    sched = sweep.build_schedule(25.0, 100.0, rel_err=0.005)
    assert len(sched.phases) == 1
    assert sched.phases[0].kind == "d2"
    # near-exact phase: two heightfield reads per sample
    assert sched.num_samples == 8


def test_horizon_dtype_and_range():
    z = gaussian_bumps_terrain(40, 40, seed=1)
    vg = _vert_grid_planar(z)
    vn, vnor = _default_vectors(10, 10)
    hori, _ = horizon.horizon_gridded(vg, 40, 40, vn, vnor, 15, 15,
                                      dist_search=0.5, azim_num=8,
                                      verbose=False)
    assert hori.dtype == np.float32
    assert (hori >= np.deg2rad(-15.0) - 1e-6).all()
    assert (hori <= np.deg2rad(89.98) + 1e-6).all()


def test_horizon_gridded_engine_sweep_matches_auto_on_cpu():
    """horizon_gridded has one engine on every platform, the XLA sweep: its
    output equals ops.sweep.horizon_sweep bit for bit, and the removed
    ``engine`` keyword is rejected."""
    import horayzon_tpu.auxiliary as aux
    rng = np.random.default_rng(3)
    n = 40
    z = rng.normal(scale=30.0, size=(n, n)).astype(np.float32)
    x = (np.arange(n, dtype=np.float32) * 25.0)[None, :].repeat(n, 0)
    y = (-np.arange(n, dtype=np.float32) * 25.0)[:, None].repeat(n, 1)
    vert = aux.rearrange_pad_buffer(x, y, z)
    in0 = in1 = 16
    off = 12
    vec_norm = np.zeros((in0, in1, 3), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((in0, in1, 3), np.float32)
    vec_north[..., 1] = 1.0
    h_api, azim = horizon.horizon_gridded(
        vert, n, n, vec_norm, vec_north, off, off, dist_search=0.25,
        azim_num=8, verbose=False)
    h_sweep, _ = sweep.horizon_sweep(
        z, dx=25.0, dy=-25.0, offset=(off, off), inner_shape=(in0, in1),
        azim=azim, dist_search=250.0)
    np.testing.assert_array_equal(h_api, np.asarray(h_sweep))
    with pytest.raises(TypeError):
        horizon.horizon_gridded(
            vert, n, n, vec_norm, vec_north, off, off, dist_search=0.25,
            azim_num=8, verbose=False, engine="sweep")


def test_masked_bbox_crop_matches_full_sweep():
    """The XLA path crops the sweep to the unmasked bounding box
    (mask-driven work reduction, reference horizon_comp.cpp:749); values
    on unmasked cells must match the unmasked run within the accuracy
    budget (cropping changes the schedule's safe-phase split, which can
    regroup d1 parabola pairs — sub-hori_acc differences) and masked
    cells get hori_fill."""
    dx = 25.0
    z = gaussian_bumps_terrain(48, 48, seed=9, amp=300.0)
    vg = _vert_grid_planar(z, dx=dx, dy=-dx)
    in0 = in1 = 16
    off = 16
    vn, vnor = _default_vectors(in0, in1)
    full, _ = horizon.horizon_gridded(
        vg, 48, 48, vn, vnor, off, off, dist_search=0.5, azim_num=8,
        verbose=False)
    mask = np.zeros((in0, in1), dtype=np.uint8)
    mask[3:9, 5:14] = 1
    got, _ = horizon.horizon_gridded(
        vg, 48, 48, vn, vnor, off, off, dist_search=0.5, azim_num=8,
        mask=mask, hori_fill=-9.0, verbose=False)
    sel = mask == 1
    d = np.abs(got[sel] - full[sel])
    assert np.rad2deg(d.max()) < 0.25, \
        f"masked bbox crop diverged: {np.rad2deg(d.max()):.4f} deg"
    assert np.median(d) == 0.0        # almost all cells bit-identical
    assert np.allclose(got[~sel], -9.0)


def test_masked_all_zero_returns_fill():
    z = np.zeros((32, 32), dtype=np.float32)
    vg = _vert_grid_planar(z)
    vn, vnor = _default_vectors(8, 8)
    mask = np.zeros((8, 8), dtype=np.uint8)
    hori, _ = horizon.horizon_gridded(
        vg, 32, 32, vn, vnor, 12, 12, dist_search=0.3, azim_num=4,
        mask=mask, hori_fill=0.5, verbose=False)
    assert np.allclose(hori, 0.5)

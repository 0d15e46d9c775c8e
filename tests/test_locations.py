import numpy as np
import pytest

from horayzon_tpu import auxiliary, horizon

from reference_impl import gaussian_bumps_terrain


def _vert_grid_planar(z, dx=25.0):
    h, w = z.shape
    x1 = np.arange(w, dtype=np.float32) * dx
    y1 = -np.arange(h, dtype=np.float32) * dx
    x, y = np.meshgrid(x1, y1)
    return auxiliary.rearrange_pad_buffer(x, y, z), x, y


def _loc_vectors(n):
    vn = np.zeros((n, 3), dtype=np.float32)
    vn[:, 2] = 1.0
    vno = np.zeros((n, 3), dtype=np.float32)
    vno[:, 1] = 1.0
    return vn, vno


def test_locations_match_gridded():
    dx = 25.0
    z = gaussian_bumps_terrain(48, 48, seed=3, amp=300.0)
    vg, x, y = _vert_grid_planar(z, dx)
    # Gridded result at a few cells
    in0 = in1 = 8
    off = 20
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_north[..., 1] = 1.0
    hori_g, azim = horizon.horizon_gridded(
        vg, 48, 48, vec_norm, vec_north, off, off, dist_search=0.8,
        azim_num=12, elev_ang_low_lim=-15.0, verbose=False)
    # Same cells as locations
    cells = [(0, 0), (3, 4), (7, 7)]
    coords = np.array([[x[off + i, off + j], y[off + i, off + j],
                        z[off + i, off + j]] for i, j in cells],
                      dtype=np.float32)
    vn, vno = _loc_vectors(len(cells))
    hori_l, azim_l = horizon.horizon_locations(
        vg, 48, 48, coords, vn, vno, dist_search=0.8, azim_num=12,
        elev_ang_low_lim=-15.0)
    np.testing.assert_allclose(azim_l, azim)
    for k, (i, j) in enumerate(cells):
        d = np.rad2deg(np.abs(hori_l[k] - hori_g[i, j])).max()
        assert d < 0.4, f"cell {i},{j}: max diff {d:.3f} deg"


def test_locations_hori_dist():
    dx = 25.0
    z = np.zeros((64, 64), dtype=np.float32)
    z[10, :] = 200.0  # wall 500 m north of row 30
    vg, x, y = _vert_grid_planar(z, dx)
    coords = np.array([[x[30, 32], y[30, 32], 0.0]], dtype=np.float32)
    vn, vno = _loc_vectors(1)
    hori, dist, azim = horizon.horizon_locations(
        vg, 64, 64, coords, vn, vno, dist_search=1.5, azim_num=4,
        hori_dist_out=True)
    # North: horizon = atan(200/500); distance ~ sqrt(500^2+200^2)
    expect_ang = np.arctan(200.0 / 500.0)
    expect_dist = np.hypot(500.0, 200.0)
    assert np.isclose(hori[0, 0], expect_ang, atol=np.deg2rad(0.6))
    assert np.isclose(dist[0, 0], expect_dist, rtol=0.08)


def test_locations_validation():
    z = np.zeros((16, 16), dtype=np.float32)
    vg, x, y = _vert_grid_planar(z)
    coords = np.zeros((2, 3), dtype=np.float32)
    vn, vno = _loc_vectors(2)
    with pytest.raises(ValueError):
        horizon.horizon_locations(vg, 16, 16, coords, vn, vno,
                                  dist_search=0.2, ray_algorithm="bogus")
    with pytest.raises(TypeError):
        horizon.horizon_locations(
            vg, 16, 16, coords, vn, vno, dist_search=0.2,
            ray_org_elev=np.array([0.0], dtype=np.float32))
    with pytest.raises(ValueError):
        horizon.horizon_locations(
            vg, 16, 16, coords, vn, vno, dist_search=0.2,
            ray_org_elev=np.array([0.01, 0.01, 0.01], dtype=np.float32))


def test_locations_per_location_ray_org_elev():
    z = np.zeros((32, 32), dtype=np.float32)
    z[10, :] = 100.0
    vg, x, y = _vert_grid_planar(z)
    # Two observers at the same place, one lifted high above the wall
    coords = np.array([[x[20, 16], y[20, 16], 0.0]] * 2, dtype=np.float32)
    vn, vno = _loc_vectors(2)
    roe = np.array([0.01, 300.0], dtype=np.float32)
    hori, azim = horizon.horizon_locations(
        vg, 32, 32, coords, vn, vno, dist_search=1.0, azim_num=4,
        ray_org_elev=roe, elev_ang_low_lim=-89.0)
    # Ground observer sees the wall (positive); lifted observer sees below
    assert hori[0, 0] > np.deg2rad(10.0)
    assert hori[1, 0] < 0.0


def test_locations_chunked_matches_unchunked(monkeypatch):
    """Many locations run through the memory-guarded chunk loop and must
    match the single-call path exactly (the guard bounds the dense
    (L, A, M) gathers for large L)."""
    from horayzon_tpu.ops import locations as loc_mod

    dx = 25.0
    z = gaussian_bumps_terrain(48, 48, seed=11, amp=300.0)
    vg, x, y = _vert_grid_planar(z, dx)
    rng = np.random.default_rng(0)
    n = 37
    ii = rng.integers(16, 32, n)
    jj = rng.integers(16, 32, n)
    coords = np.stack([x[ii, jj], y[ii, jj], z[ii, jj]], axis=-1) \
        .astype(np.float32)
    vn, vno = _loc_vectors(n)

    h_one, d_one, _ = horizon.horizon_locations(
        vg, 48, 48, coords, vn, vno, dist_search=0.8, azim_num=12,
        elev_ang_low_lim=-15.0, hori_dist_out=True)
    # Force per-location chunking (chunk = max(1, 1 // (A*M)) = 1),
    # exercising the padded-tail path too
    monkeypatch.setattr(loc_mod, "MAX_GATHER_ELEMS", 1)
    h_chunk, d_chunk, _ = horizon.horizon_locations(
        vg, 48, 48, coords, vn, vno, dist_search=0.8, azim_num=12,
        elev_ang_low_lim=-15.0, hori_dist_out=True)
    np.testing.assert_array_equal(h_chunk, h_one)
    np.testing.assert_array_equal(d_chunk, d_one)

import numpy as np
import pytest

from horayzon_tpu.ops import multires, sweep

from reference_impl import gaussian_bumps_terrain


def _downsample_max(z, r):
    h, w = z.shape
    return z[:h - h % r, :w - w % r].reshape(h // r, r, w // r, r) \
        .max(axis=(1, 3))


def test_multires_matches_full_resolution():
    """Fine+coarse sweep agrees with the full-resolution sweep within the
    far-field error budget."""
    dx = 25.0
    full = gaussian_bumps_terrain(512, 512, seed=21, amp=500.0, n_bumps=25)
    # Fine grid: centre crop; coarse grid: 2x max-downsample of everything
    r_log2 = 1
    r = 2 ** r_log2
    fine_o = 64          # fine grid starts at full[64, 64]
    z_fine = full[fine_o:fine_o + 384, fine_o:fine_o + 384]
    z_coarse = _downsample_max(full, r)
    azim = (2 * np.pi / 8) * np.arange(8)
    inner = (32, 32)
    off_full = (fine_o + 176, fine_o + 176)  # centre of the fine grid
    off_fine = (176, 176)
    dist = 6000.0
    acc = 0.5

    h_full, _ = sweep.horizon_sweep(
        full, dx=dx, dy=-dx, offset=off_full, inner_shape=inner,
        azim=azim, dist_search=dist, hori_acc=acc)
    h_mr = multires.horizon_sweep_multires(
        z_fine, z_coarse, ratio_log2=r_log2, coarse_offset=(fine_o, fine_o),
        dx=dx, dy=-dx, offset=off_fine, inner_shape=inner, azim=azim,
        dist_search=dist, hori_acc=acc)
    d = np.rad2deg(np.abs(np.asarray(h_mr) - np.asarray(h_full)))
    # Coarse far field is conservative (max-downsampled) -> small positive
    # bias allowed; tolerance ~2x hori_acc
    assert d.max() < 2 * acc, f"multires max diff {d.max():.3f} deg"


def test_rasterize_tin_plane():
    """A TIN of a sloping plane rasterises to the exact plane heights."""
    # two triangles covering [0, 100] x [-100, 0]
    verts = np.array([[0.0, 0.0, 10.0], [100.0, 0.0, 20.0],
                      [0.0, -100.0, 30.0], [100.0, -100.0, 40.0]],
                     dtype=np.float32).ravel()
    tris = np.array([0, 1, 2, 1, 3, 2], dtype=np.int32)
    out = multires.rasterize_tin(verts, tris, origin_xy=(0.0, 0.0),
                                 spacing_xy=(25.0, -25.0), shape=(5, 5))
    xj = np.arange(5) * 25.0
    yi = np.arange(5) * -25.0
    expect = 10.0 + 0.1 * xj[None, :] - 0.2 * yi[:, None]
    np.testing.assert_allclose(out, expect, atol=1e-4)
    # points outside all triangles get the sentinel
    out2 = multires.rasterize_tin(verts, tris, origin_xy=(-50.0, 0.0),
                                  spacing_xy=(25.0, -25.0), shape=(2, 2))
    assert (out2[:, 0] < -1e4).all()


def test_horizon_gridded_tin_route():
    """horizon_gridded(vert_simp=...) routes to the multires engine and
    matches the full-resolution run within the error budget."""
    from horayzon_tpu import horizon as _hz
    from horayzon_tpu import terrain as _terrain

    dx = 25.0
    dist_km = 2.0
    acc = 2.0
    halo_full = int(dist_km * 1000.0 / dx) + 16
    inner = 16
    n_full = inner + 2 * halo_full
    full = gaussian_bumps_terrain(n_full, n_full, seed=13, amp=600.0)
    x = np.arange(n_full, dtype=np.float64) * dx
    y = -np.arange(n_full, dtype=np.float64) * dx

    vec_norm = np.zeros((inner, inner, 3), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((inner, inner, 3), np.float32)
    vec_north[..., 1] = 1.0

    def vert_grid_of(xa, ya, za):
        from horayzon_tpu.auxiliary import rearrange_pad_buffer
        x2, y2 = np.meshgrid(xa, ya)
        return rearrange_pad_buffer(x2.astype(np.float32),
                                    y2.astype(np.float32),
                                    za.astype(np.float32))

    vg_full = vert_grid_of(x, y, full)
    h_ref, _ = _hz.horizon_gridded(
        vg_full, n_full, n_full, vec_norm, vec_north, halo_full, halo_full,
        dist_km, azim_num=8, hori_acc=acc, verbose=False)

    # fine window + TIN of the max-pooled far field (2 tris per quad)
    r = 4
    halo_fine = 48
    i0 = halo_full - halo_fine
    n_fine = inner + 2 * halo_fine
    z_fine = full[i0:i0 + n_fine, i0:i0 + n_fine]
    pooled = _downsample_max(full, r)
    nc = pooled.shape[0]
    xv, yv = np.meshgrid(x[:nc * r:r] - i0 * dx, y[:nc * r:r] - (-i0 * dx))
    verts = np.stack([xv, yv, pooled.astype(np.float64)],
                     axis=-1).reshape(-1, 3).astype(np.float32)
    q = np.arange(nc - 1)
    jj, ii = np.meshgrid(q, q)
    a = (ii * nc + jj).ravel()
    tris = np.concatenate([
        np.stack([a, a + 1, a + nc], -1),
        np.stack([a + 1, a + nc + 1, a + nc], -1)]).astype(np.int32).ravel()

    vg_fine = vert_grid_of(x[i0:i0 + n_fine] - i0 * dx,
                           y[i0:i0 + n_fine] + i0 * dx, z_fine)
    h_tin, _ = _hz.horizon_gridded(
        vg_fine, n_fine, n_fine, vec_norm, vec_north, halo_fine, halo_fine,
        dist_km, azim_num=8, hori_acc=acc, verbose=False,
        vert_simp=verts.ravel(), num_vert_simp=len(verts),
        tri_ind_simp=tris, num_tri_simp=len(tris) // 3)
    d = np.rad2deg(np.abs(h_tin - h_ref))
    assert d.max() < 2 * acc, f"TIN route max diff {d.max():.3f} deg"
    # vert_simp without tri_ind_simp must raise, never be ignored
    with pytest.raises(ValueError, match="together"):
        _hz.horizon_gridded(
            vg_fine, n_fine, n_fine, vec_norm, vec_north, halo_fine,
            halo_fine, dist_km, azim_num=8, verbose=False,
            vert_simp=verts.ravel(), num_vert_simp=len(verts))


def test_multires_halo_validation():
    z_fine = np.zeros((64, 64), dtype=np.float32)
    z_coarse = np.zeros((128, 128), dtype=np.float32)
    azim = np.zeros(2)
    with pytest.raises(ValueError, match="halo"):
        multires.horizon_sweep_multires(
            z_fine, z_coarse, ratio_log2=2, coarse_offset=(0, 0),
            dx=25.0, dy=-25.0, offset=(28, 28), inner_shape=(8, 8),
            azim=azim, dist_search=50000.0, hori_acc=0.25)


def test_multires_alignment_validation():
    z_fine = np.zeros((64, 64), dtype=np.float32)
    z_coarse = np.zeros((64, 64), dtype=np.float32)
    sched = sweep.build_schedule(25.0, 5000.0, 0.005)
    with pytest.raises(ValueError, match="aligned"):
        multires.combined_pyramid(z_fine, z_coarse, 2, (3, 0), sched)

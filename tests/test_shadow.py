import numpy as np
import pytest

from horayzon_tpu import auxiliary, shadow, topo_param
from horayzon_tpu.ops import refraction

from reference_impl import brute_shadow, gaussian_bumps_terrain


def _planar_setup(z, dx=25.0, off=8, inner=None):
    h, w = z.shape
    if inner is None:
        inner = (h - 2 * off, w - 2 * off)
    x1 = np.arange(w, dtype=np.float32) * dx
    y1 = -np.arange(h, dtype=np.float32) * dx
    xx, yy = np.meshgrid(x1, y1)
    vert_grid = auxiliary.rearrange_pad_buffer(xx, yy, z)
    in0, in1 = inner
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    sl1 = (slice(off - 1, off + in0 + 1), slice(off - 1, off + in1 + 1))
    vec_tilt = np.ascontiguousarray(topo_param.slope_plane_meth(
        xx[sl1], yy[sl1], z[sl1])[1:-1, 1:-1])
    surf_enl = topo_param.surface_enlargement_factor(vec_norm, vec_tilt)
    mask = np.ones((in0, in1), dtype=np.uint8)
    elev_in = np.ascontiguousarray(z[off:off + in0, off:off + in1])
    t = shadow.Terrain()
    t.initialise(vert_grid, h, w, off, off, vec_tilt, vec_norm, surf_enl,
                 elev_in, mask)
    return t, vec_tilt, xx, yy


def test_flat_terrain_sun_up_all_illuminated():
    z = np.zeros((48, 48), dtype=np.float32)
    t, *_ = _planar_setup(z)
    sun = np.array([0.0, 1.0e7, 1.0e7], dtype=np.float32)
    sh = t.shadow(sun)
    assert (sh == 0).all()
    sw = t.sw_dir_cor(sun)
    np.testing.assert_allclose(sw, 1.0, atol=1e-4)


def test_flat_terrain_sun_below_self_shaded():
    z = np.zeros((48, 48), dtype=np.float32)
    t, *_ = _planar_setup(z)
    sun = np.array([0.0, 1.0e7, -1.0e6], dtype=np.float32)
    sh = t.shadow(sun)
    assert (sh == 1).all()
    sw = t.sw_dir_cor(sun)
    np.testing.assert_allclose(sw, 0.0, atol=1e-6)


def test_shadow_matches_bruteforce():
    dx = 25.0
    z = gaussian_bumps_terrain(48, 48, seed=11, amp=600.0)
    off = 8
    inner = (32, 32)
    t, vec_tilt, *_ = _planar_setup(z, dx=dx, off=off, inner=inner)
    # Low sun from the east
    sun = np.array([1.0e7, 0.0, 1.5e6], dtype=np.float32)
    sh = np.asarray(t.shadow(sun))
    occ_ref = brute_shadow(z, dx, -dx, (off, off), inner, sun,
                           step_frac=0.25)
    # Self-shading takes precedence over terrain shading in the encoding
    # (shadow_comp.cpp:449-478): compare the terrain-occlusion bit only on
    # sun-facing cells (dot(tilt, sun) > 0).
    sun_u = sun / np.linalg.norm(sun)
    facing = (vec_tilt @ sun_u) > 0.0
    got_occ = sh == 2
    frac = (got_occ != occ_ref)[facing].mean()
    assert frac < 0.03, f"shadow mismatch fraction {frac:.3f}"
    assert got_occ.any() and (~got_occ).any()
    # Cells coded 1 must indeed be non-sun-facing
    assert (~facing[sh == 1]).all()


def test_shadow_mask_and_fill():
    z = np.zeros((48, 48), dtype=np.float32)
    dx = 25.0
    h, w = z.shape
    off, in0, in1 = 8, 32, 32
    x1 = np.arange(w, dtype=np.float32) * dx
    y1 = -np.arange(h, dtype=np.float32) * dx
    xx, yy = np.meshgrid(x1, y1)
    vert_grid = auxiliary.rearrange_pad_buffer(xx, yy, z)
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    vec_tilt = vec_norm.copy()
    surf = np.ones((in0, in1), dtype=np.float32)
    mask = np.ones((in0, in1), dtype=np.uint8)
    mask[:4] = 0
    t = shadow.Terrain()
    t.initialise(vert_grid, h, w, off, off, vec_tilt, vec_norm, surf,
                 z[off:off + in0, off:off + in1], mask,
                 sw_dir_cor_fill=-7.0)
    sun = np.array([0.0, 1e7, 1e7], dtype=np.float32)
    sh = t.shadow(sun)
    assert (sh[:4] == 3).all() and (sh[4:] == 0).all()
    sw = t.sw_dir_cor(sun)
    assert np.allclose(sw[:4], -7.0)


def test_shadow_batch_consistent():
    z = gaussian_bumps_terrain(48, 48, seed=5, amp=500.0)
    t, *_ = _planar_setup(z)
    suns = np.array([[1e7, 0, 2e6], [0, 1e7, 5e6], [-1e7, 0, 1e6]],
                    dtype=np.float32)
    batch = t.shadow_batch(suns)
    for i in range(3):
        single = t.shadow(suns[i])
        np.testing.assert_array_equal(batch[i], single)
    swb = t.sw_dir_cor_batch(suns)
    for i in range(3):
        np.testing.assert_allclose(swb[i], t.sw_dir_cor(suns[i]),
                                   atol=1e-6)


def test_sw_dir_cor_mueller_scherer_formula():
    """Unshaded tilted plane: sw_dir_cor = cos(incidence)/cos(zenith) * fac."""
    z = np.zeros((48, 48), dtype=np.float32)
    dx = 25.0
    h, w = z.shape
    off, in0, in1 = 8, 32, 32
    x1 = np.arange(w, dtype=np.float32) * dx
    y1 = -np.arange(h, dtype=np.float32) * dx
    xx, yy = np.meshgrid(x1, y1)
    vert_grid = auxiliary.rearrange_pad_buffer(xx, yy, z)
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    # tilt 30 degrees toward east
    vec_tilt = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_tilt[..., 0] = np.sin(np.deg2rad(30.0))
    vec_tilt[..., 2] = np.cos(np.deg2rad(30.0))
    surf = np.full((in0, in1), 1.3, dtype=np.float32)
    mask = np.ones((in0, in1), dtype=np.uint8)
    t = shadow.Terrain()
    t.initialise(vert_grid, h, w, off, off, vec_tilt, vec_norm, surf,
                 z[off:off + in0, off:off + in1], mask)
    # Sun from the east at 45 degrees elevation
    sun = np.array([1e7, 0.0, 1e7], dtype=np.float32) / np.sqrt(2)
    sw = np.asarray(t.sw_dir_cor(sun))
    sun_u = np.array([1, 0, 1]) / np.sqrt(2)
    tilt = np.array([np.sin(np.deg2rad(30)), 0, np.cos(np.deg2rad(30))])
    expect = (tilt @ sun_u) / (np.array([0, 0, 1]) @ sun_u) * 1.3
    np.testing.assert_allclose(sw, expect, atol=5e-3)


def test_refraction_values():
    # Saemundsson at the horizon, standard conditions: ~0.48 deg at
    # T=10 degC, p=101 kPa
    r0 = float(refraction.atmos_refrac(0.0, 10.0, 101.0))
    assert 0.4 < r0 < 0.6
    # Near zenith: ~0
    r90 = float(refraction.atmos_refrac(90.0, 10.0, 101.0))
    assert abs(r90) < 1e-3
    # Monotone decreasing with elevation
    elevs = np.linspace(-1, 90, 50)
    vals = np.array([float(refraction.atmos_refrac(e, 10.0, 101.0))
                     for e in elevs])
    assert (np.diff(vals) < 1e-9).all()


def test_refraction_rotation_lifts_sun():
    import jax.numpy as jnp
    sun = jnp.asarray(np.array([[0.9397, 0.0, 0.342]], dtype=np.float32))
    norm = jnp.asarray(np.array([[0.0, 0.0, 1.0]], dtype=np.float32))
    elev = jnp.asarray(np.array([0.0], dtype=np.float32))
    out = np.asarray(refraction.refract_sun_vector(sun, norm, elev))
    # Refraction lifts the apparent sun
    assert out[0, 2] > 0.342
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)


def test_shadow_scan_matches_sweep_metric():
    """Log-doubling scan occlusion agrees with the marching sweep."""
    import jax.numpy as jnp

    from horayzon_tpu.ops import shadow_scan, sweep

    dx = 25.0
    z = gaussian_bumps_terrain(64, 64, seed=17, amp=500.0)
    off = (16, 16)
    inner = (32, 32)
    z_in = z[16:48, 16:48]
    z_org = z_in + 0.05
    diag = np.hypot(64 * dx, 64 * dx)
    # Sun east at ~12 degrees
    ux, uy, m = 1.0, 0.0, 0.2
    u_cells = np.array([uy / (-dx), ux / dx], dtype=np.float32)
    sched = sweep.build_schedule(dx, diag, sweep.default_rel_err(0.25))
    m_sweep = np.asarray(sweep.shadow_metric(
        jnp.asarray(z), jnp.asarray(z_org), jnp.asarray(z_in),
        jnp.full(inner, m, np.float32), u_cells, sched, off, inner))
    m_scan = np.asarray(shadow_scan.shadow_scan_metric(
        jnp.asarray(z), jnp.asarray(z_org), jnp.float32(m), u_cells, dx,
        diag, off, inner))
    occ_sweep = m_sweep > 0
    occ_scan = m_scan > 0
    agree = (occ_sweep == occ_scan).mean()
    assert agree > 0.97, f"scan vs sweep occlusion agreement {agree:.3f}"
    # metric values close away from the decision boundary
    both = np.abs(m_sweep) > 5.0
    assert np.abs(m_scan - m_sweep)[both].max() < 30.0


def test_terrain_scan_engine_matches_sweep_engine():
    z = gaussian_bumps_terrain(48, 48, seed=5, amp=500.0)
    t1, vec_tilt, xx, yy = _planar_setup(z)
    # Build a second terrain with the scan engine
    h, w = z.shape
    off, in0, in1 = 8, 32, 32
    vert_grid = auxiliary.rearrange_pad_buffer(xx.astype(np.float32),
                                               yy.astype(np.float32), z)
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    surf = topo_param.surface_enlargement_factor(vec_norm, vec_tilt)
    mask = np.ones((in0, in1), dtype=np.uint8)
    t2 = shadow.Terrain()
    t2.initialise(vert_grid, h, w, off, off, vec_tilt, vec_norm, surf,
                  np.ascontiguousarray(z[off:off + in0, off:off + in1]),
                  mask, engine="scan")
    for sun in [np.array([1e7, 0, 2e6], np.float32),
                np.array([-4e6, 8e6, 1.5e6], np.float32)]:
        s1 = t1.shadow(sun)
        s2 = t2.shadow(sun)
        agree = (s1 == s2).mean()
        assert agree > 0.97, f"engine agreement {agree:.3f}"
        c1 = t1.sw_dir_cor(sun)
        c2 = t2.sw_dir_cor(sun)
        close = np.isclose(c1, c2, atol=0.05).mean()
        assert close > 0.97


@pytest.mark.parametrize("engine", ["pallas", "auto"])
def test_terrain_rejects_removed_engines(engine):
    """Only the marching sweep and the scan remain; the removed engine
    names raise instead of silently picking another engine."""
    z = gaussian_bumps_terrain(48, 48, seed=5, amp=500.0)
    _, vec_tilt, xx, yy = _planar_setup(z)
    off, in0, in1 = 8, 32, 32
    vert_grid = auxiliary.rearrange_pad_buffer(xx.astype(np.float32),
                                               yy.astype(np.float32), z)
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    t = shadow.Terrain()
    with pytest.raises(ValueError, match="engine"):
        t.initialise(vert_grid, 48, 48, off, off, vec_tilt, vec_norm,
                     np.ones((in0, in1), np.float32),
                     np.ascontiguousarray(z[off:off + in0, off:off + in1]),
                     np.ones((in0, in1), np.uint8), engine=engine)

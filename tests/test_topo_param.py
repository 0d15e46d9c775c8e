import numpy as np
import pytest

from horayzon_tpu import topo_param


def _plane_grid(a=0.3, b=-0.2, n=8, d=10.0):
    x1 = np.arange(n) * d
    y1 = np.arange(n) * d
    x, y = np.meshgrid(x1, y1)
    z = a * x + b * y
    return (x.astype(np.float32), y.astype(np.float32),
            z.astype(np.float32))


def test_slope_plane_meth_inclined_plane():
    a, b = 0.3, -0.2
    x, y, z = _plane_grid(a, b)
    vec = topo_param.slope_plane_meth(x, y, z)
    expect = np.array([-a, -b, 1.0])
    expect = expect / np.linalg.norm(expect)
    assert np.isnan(vec[0, 0]).all()  # border is NaN
    inner = vec[1:-1, 1:-1]
    assert np.allclose(inner, expect, atol=1e-5)


def test_slope_vector_meth_inclined_plane():
    a, b = 0.1, 0.25
    x, y, z = _plane_grid(a, b)
    vec = topo_param.slope_vector_meth(x, y, z)
    expect = np.array([-a, -b, 1.0])
    expect = expect / np.linalg.norm(expect)
    inner = vec[1:-1, 1:-1]
    assert np.allclose(inner, expect, atol=1e-5)


def test_slope_methods_agree_on_smooth_terrain():
    n, d = 12, 25.0
    x1 = np.arange(n) * d
    x, y = np.meshgrid(x1, x1)
    z = (100.0 * np.sin(x / 150.0) * np.cos(y / 200.0)).astype(np.float32)
    v1 = topo_param.slope_plane_meth(x.astype(np.float32),
                                     y.astype(np.float32), z)
    v2 = topo_param.slope_vector_meth(x.astype(np.float32),
                                      y.astype(np.float32), z)
    dots = np.sum(v1[1:-1, 1:-1] * v2[1:-1, 1:-1], axis=-1)
    assert (dots > 0.999).all()


def test_slope_plane_meth_with_identity_rot():
    x, y, z = _plane_grid()
    rot = np.zeros(x.shape + (3, 3), dtype=np.float32)
    rot[...] = np.eye(3, dtype=np.float32)
    v_no = topo_param.slope_plane_meth(x, y, z)
    v_id = topo_param.slope_plane_meth(x, y, z, rot_mat=rot)
    assert np.allclose(v_no[1:-1, 1:-1], v_id[1:-1, 1:-1], atol=1e-6)


def test_sky_view_factor_flat():
    azim = np.linspace(0, 2 * np.pi, 36, endpoint=False).astype(np.float32)
    hori = np.zeros((4, 5, 36), dtype=np.float32)
    tilt = np.zeros((4, 5, 3), dtype=np.float32)
    tilt[..., 2] = 1.0
    svf = topo_param.sky_view_factor(azim, hori, tilt)
    assert np.allclose(svf, 1.0, atol=1e-5)


def test_sky_view_factor_blocked():
    # Horizon at 90 degrees everywhere -> SVF ~ 0
    azim = np.linspace(0, 2 * np.pi, 36, endpoint=False).astype(np.float32)
    hori = np.full((2, 2, 36), np.pi / 2 - 1e-4, dtype=np.float32)
    tilt = np.zeros((2, 2, 3), dtype=np.float32)
    tilt[..., 2] = 1.0
    svf = topo_param.sky_view_factor(azim, hori, tilt)
    assert np.allclose(svf, 0.0, atol=1e-3)


def test_visible_sky_fraction_flat():
    azim = np.linspace(0, 2 * np.pi, 24, endpoint=False).astype(np.float32)
    hori = np.zeros((3, 3, 24), dtype=np.float32)
    tilt = np.zeros((3, 3, 3), dtype=np.float32)
    tilt[..., 2] = 1.0
    vsf = topo_param.visible_sky_fraction(azim, hori, tilt)
    assert np.allclose(vsf, 1.0, atol=1e-5)


def test_topographic_openness():
    azim = np.linspace(0, 2 * np.pi, 8, endpoint=False).astype(np.float32)
    hori = np.full((2, 2, 8), np.deg2rad(10.0), dtype=np.float32)
    top = topo_param.topographic_openness(azim, hori)
    assert np.allclose(top, np.pi / 2 - np.deg2rad(10.0), atol=1e-6)


def test_surface_enlargement_factor():
    norm = np.zeros((2, 2, 3), dtype=np.float32)
    norm[..., 2] = 1.0
    tilt = np.zeros((2, 2, 3), dtype=np.float32)
    tilt[..., 2] = np.cos(np.deg2rad(60.0))
    tilt[..., 0] = np.sin(np.deg2rad(60.0))
    fac = topo_param.surface_enlargement_factor(norm, tilt)
    assert np.allclose(fac, 2.0, atol=1e-5)


def test_slope_angle_aspect():
    tilt = np.zeros((1, 1, 3), dtype=np.float32)
    tilt[..., 0] = np.sin(np.deg2rad(30.0))   # leaning east
    tilt[..., 2] = np.cos(np.deg2rad(30.0))
    slope, aspect = topo_param.slope_angle_aspect(tilt)
    assert np.allclose(slope, np.deg2rad(30.0), atol=1e-5)
    assert np.allclose(aspect, np.pi / 2, atol=1e-5)  # facing east


def _curved_rotation_case():
    """ENU mesh of a bumpy spherical cap with its per-cell rotations."""
    from horayzon_tpu import direction, transform

    n, dlat = 40, 0.002
    lat = 45.0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = 7.0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    elev = (800.0 * np.exp(-((lon2 - 7.01) ** 2 + (lat2 - 44.99) ** 2)
                           / (2 * 0.01 ** 2))).astype(np.float32)
    trans = transform.TransformerEcef2enu(7.0, 45.0, "sphere")
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elev, "sphere")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)
    sl = (slice(1, -1), slice(1, -1))
    vn = direction.surf_norm(lon2[sl], lat2[sl])
    vno = direction.north_dir(xe[sl], ye[sl], ze[sl], vn, "sphere")
    rot = transform.rotation_matrix_glob2loc(
        transform.ecef2enu_vector(vno, trans),
        transform.ecef2enu_vector(vn, trans))
    return x, y, z, rot


def _slope_plane_f64(x, y, z, rot, output_rot):
    """float64 numpy reference of the rotated 9-point plane fit."""
    x, y, z = (np.asarray(a, np.float64) for a in (x, y, z))
    rot = np.asarray(rot, np.float64)
    h, w = x.shape
    out = np.full((h, w, 3), np.nan)
    for i in range(1, h - 1):
        for j in range(1, w - 1):
            c = np.stack([x[i - 1:i + 2, j - 1:j + 2].ravel() - x[i, j],
                          y[i - 1:i + 2, j - 1:j + 2].ravel() - y[i, j],
                          z[i - 1:i + 2, j - 1:j + 2].ravel() - z[i, j]])
            c = rot[i, j] @ c
            a_mat = np.stack([c[0], c[1], np.ones(9)], axis=-1)
            v = np.linalg.lstsq(a_mat, c[2], rcond=None)[0]
            vec = np.array([v[0], v[1], -1.0])
            vec /= np.linalg.norm(vec)
            vec = -vec if vec[2] < 0 else vec
            out[i, j] = vec if output_rot else rot[i, j].T @ vec
    return out


def _slope_vector_f64(x, y, z, rot):
    """float64 numpy reference of the rotated 4-triangle normal."""
    p = np.stack([np.asarray(a, np.float64) for a in (x, y, z)], axis=-1)
    rot = np.asarray(rot, np.float64)
    c = p[1:-1, 1:-1]
    left, down = p[1:-1, :-2] - c, p[2:, 1:-1] - c
    right, up = p[1:-1, 2:] - c, p[:-2, 1:-1] - c
    vec = (np.cross(left, down) + np.cross(down, right)
           + np.cross(right, up) + np.cross(up, left))
    vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
    vec = np.where(vec[..., 2:3] < 0.0, -vec, vec)
    vec = np.einsum("hwab,hwb->hwa", rot[1:-1, 1:-1], vec)
    out = np.full(p.shape, np.nan)
    out[1:-1, 1:-1] = vec
    return out


@pytest.mark.parametrize("method", ["plane_local", "plane_global",
                                    "vector_local"])
def test_rotated_normals_match_float64(method):
    """The per-cell rotations keep float32 accuracy (no reduced-precision
    matrix units): unit normals agree with a float64 reference to 2e-5
    (float32 reaches ~1e-7 here), where rotations truncated to TF32's
    10-bit mantissa err by ~2e-4."""
    x, y, z, rot = _curved_rotation_case()
    if method == "vector_local":
        got = topo_param.slope_vector_meth(x, y, z, rot_mat=rot,
                                           output_rot=True)
        ref = _slope_vector_f64(x, y, z, rot)
    else:
        local = method == "plane_local"
        got = topo_param.slope_plane_meth(x, y, z, rot_mat=rot,
                                          output_rot=local)
        ref = _slope_plane_f64(x, y, z, rot, local)
    sl = (slice(2, -2), slice(2, -2))    # the rotation field's NaN rim
    err = np.abs(got[sl] - ref[sl]).max()
    assert np.isfinite(got[sl]).all()
    assert err < 2e-5, f"max component error {err:.2e}"
    # the terrain is tilted: the check is not a trivial (0, 0, 1)
    assert np.abs(ref[sl][..., :2]).max() > 0.05

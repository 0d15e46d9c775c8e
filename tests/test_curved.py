import numpy as np
import pytest

from horayzon_tpu import (auxiliary, direction, domain, horizon, regrid,
                          transform)


def _curved_setup(elev_fn, n=160, dlat=0.002, lat0=45.0, lon0=7.0):
    """Build a curved-Earth test domain: lon/lat grid -> ENU mesh.

    Returns dict with everything horizon_gridded needs."""
    lat = lat0 + (np.arange(n)[::-1] - n / 2) * dlat   # descending (north-up)
    lon = lon0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    elevation = elev_fn(lon2, lat2).astype(np.float32)

    trans = transform.TransformerEcef2enu(lon0, lat0, "sphere")
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elevation, "sphere")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)

    vn_ecef = direction.surf_norm(lon2, lat2)
    vnorth_ecef = direction.north_dir(xe, ye, ze, vn_ecef, "sphere")
    vec_norm = transform.ecef2enu_vector(vn_ecef, trans)
    vec_north = transform.ecef2enu_vector(vnorth_ecef, trans)

    return dict(lon=lon, lat=lat, x=x, y=y, z=z, elevation=elevation,
                vec_norm=vec_norm, vec_north=vec_north, trans=trans,
                lon2=lon2, lat2=lat2)


def test_planarize_roundtrip_flat():
    """Planarising a zero-terrain spherical cap reproduces the ENU z
    (curvature drop) at the resample points."""
    s = _curved_setup(lambda lon, lat: np.zeros_like(lon), n=80)
    pg = regrid.planarize(s["x"], s["y"], s["z"])
    assert pg.valid.mean() > 0.9
    # At valid points, the resampled z equals the spherical drop
    # z ~= -(x^2+y^2) / (2R)
    g = pg.grid
    xg = g.x0 + np.arange(g.shape[1]) * g.dx
    yg = g.y0 + np.arange(g.shape[0]) * g.dy
    xx, yy = np.meshgrid(xg, yg)
    r = 6370997.0
    expect = -(xx ** 2 + yy ** 2) / (2 * r)
    err = np.abs(pg.z - expect)[pg.valid]
    assert err.max() < 1.0  # metres


def test_invert_mapping_accuracy():
    s = _curved_setup(lambda lon, lat: np.zeros_like(lon), n=60)
    # Pick known grid points: inverse mapping must recover their indices
    ii, jj = np.mgrid[5:55:7, 5:55:7]
    xt = s["x"][ii, jj]
    yt = s["y"][ii, jj]
    fi, fj, ok = regrid.invert_mapping(
        s["x"].astype(np.float64), s["y"].astype(np.float64), xt, yt)
    assert ok.all()
    assert np.abs(fi - ii).max() < 1e-2
    assert np.abs(fj - jj).max() < 1e-2


def test_curved_flat_sphere_horizon_near_zero():
    """Zero terrain on the sphere: horizon is the (tiny) geometric dip."""
    s = _curved_setup(lambda lon, lat: np.zeros_like(lon), n=120)
    n = 120
    in_sl = (slice(50, 70), slice(50, 70))
    off0, off1 = 50, 50
    vert_grid = auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"])
    hori, azim = horizon.horizon_gridded(
        vert_grid, n, n, s["vec_norm"][in_sl], s["vec_north"][in_sl],
        off0, off1, dist_search=5.0, azim_num=8, verbose=False)
    # Dip for a 0.01 m observer is ~-0.006 deg; allow the sampling floor
    assert np.abs(np.rad2deg(hori)).max() < 0.1


def test_curved_wall_with_earth_curvature():
    """A wall at ~13 km: the horizon angle must match the exact ENU
    geometry (including the Earth-curvature drop of the wall)."""
    lat_wall = 45.0 + 0.12  # ~13.3 km north
    wall_h = 400.0

    def elev_fn(lon, lat):
        e = np.zeros_like(lon)
        e[np.abs(lat - lat_wall) < 0.002] = wall_h
        return e

    s = _curved_setup(elev_fn, n=160, dlat=0.002)
    n = 160
    in_sl = (slice(78, 82), slice(78, 82))
    off0 = off1 = 78
    vert_grid = auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"])
    hori, azim = horizon.horizon_gridded(
        vert_grid, n, n, s["vec_norm"][in_sl], s["vec_north"][in_sl],
        off0, off1, dist_search=20.0, azim_num=4, verbose=False)

    # Expected: elevation angle of the wall crest seen from the centre cell,
    # computed from exact double-precision ENU coordinates
    i_obs, j_obs = 80, 80
    o = np.array([s["x"][i_obs, j_obs], s["y"][i_obs, j_obs],
                  s["z"][i_obs, j_obs]], dtype=np.float64)
    nvec = s["vec_norm"][i_obs, j_obs].astype(np.float64)
    nnorth = s["vec_north"][i_obs, j_obs].astype(np.float64)
    mask_wall = np.abs(s["lat2"][:, j_obs] - lat_wall) < 0.002
    i_wall = np.where(mask_wall)[0]
    best = -np.inf
    for iw in i_wall:
        p = np.array([s["x"][iw, j_obs], s["y"][iw, j_obs],
                      s["z"][iw, j_obs]], dtype=np.float64)
        w = p - o
        ang = np.arctan2(w @ nvec, w @ nnorth)
        best = max(best, ang)
    got = hori[2, 2, 0]  # azimuth 0 = north
    assert abs(np.rad2deg(got - best)) < 0.3, \
        f"wall angle {np.rad2deg(got):.3f} vs expected {np.rad2deg(best):.3f}"
    # Sanity: the flat-Earth angle would be noticeably larger
    flat_best = -np.inf
    for iw in i_wall:
        d = np.hypot(s["x"][iw, j_obs] - o[0], s["y"][iw, j_obs] - o[1])
        flat_best = max(flat_best, np.arctan(wall_h / d))
    assert (flat_best - best) > np.deg2rad(0.03)


def test_curved_domain_outer():
    dom = domain.curved_grid({"lon_min": 6.9, "lon_max": 7.1,
                              "lat_min": 44.9, "lat_max": 45.1},
                             dist_search=20.0, ellps="sphere")
    assert dom["lat_max"] > 45.1 and dom["lat_min"] < 44.9


def test_curved_shadow_terrain():
    """Curved-mesh Terrain: a wall north of the observer shades it when the
    sun is low in the north, and not when the sun is south."""
    from horayzon_tpu import shadow, topo_param

    lat_wall = 45.0 + 0.05  # ~5.5 km north
    wall_h = 800.0

    def elev_fn(lon, lat):
        e = np.zeros_like(lon)
        e[np.abs(lat - lat_wall) < 0.002] = wall_h
        return e

    s = _curved_setup(elev_fn, n=120, dlat=0.002)
    n = 120
    off0 = off1 = 50
    in0 = in1 = 20
    sl = (slice(off0, off0 + in0), slice(off1, off1 + in1))
    vert_grid = auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"])
    vec_norm = np.ascontiguousarray(s["vec_norm"][sl])
    vec_tilt = vec_norm.copy()
    surf = np.ones((in0, in1), dtype=np.float32)
    mask = np.ones((in0, in1), dtype=np.uint8)
    t = shadow.Terrain()
    t.initialise(vert_grid, n, n, off0, off1, vec_tilt, vec_norm, surf,
                 s["elevation"][sl], mask)
    # Sun low in the north (elevation ~4 deg): wall shadow reaches ~11 km
    sun_n = np.array([0.0, 1.0e7, 0.7e6], dtype=np.float32)
    sh_n = t.shadow(sun_n)
    assert (sh_n == 2).mean() > 0.5
    # Sun high in the south: no shadow
    sun_s = np.array([0.0, -1.0e7, 1.0e7], dtype=np.float32)
    sh_s = t.shadow(sun_s)
    assert (sh_s == 0).all()


def test_curved_shadow_refraction_smoke():
    from horayzon_tpu import shadow

    s = _curved_setup(lambda lon, lat: np.zeros_like(lon), n=60)
    off = 20
    in0 = in1 = 20
    sl = (slice(off, off + in0), slice(off, off + in1))
    vert_grid = auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"])
    vec_norm = np.ascontiguousarray(s["vec_norm"][sl])
    surf = np.ones((in0, in1), dtype=np.float32)
    mask = np.ones((in0, in1), dtype=np.uint8)
    t = shadow.Terrain()
    t.initialise(vert_grid, 60, 60, off, off, vec_norm.copy(), vec_norm,
                 surf, s["elevation"][sl], mask, refrac_cor=True)
    # Sun just below the horizontal: refraction lifts it above -> some cells
    # become illuminated that would be self-shaded without refraction
    sun = np.array([0.0, 1.0e7, -2.0e4], dtype=np.float32)
    sw = t.sw_dir_cor(sun)
    assert np.isfinite(sw).all()


def test_curved_pipeline_end_to_end():
    from horayzon_tpu.models import CurvedPipeline

    n = 100
    dlat = 0.002
    lat = 45.0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = 7.0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    elevation = (500.0 * np.exp(-((lon2 - 7.0) ** 2 + (lat2 - 45.0) ** 2)
                                / (2 * 0.02 ** 2))).astype(np.float32)
    dom = {"lon_min": 6.97, "lon_max": 7.03,
           "lat_min": 44.97, "lat_max": 45.03}
    pipe = CurvedPipeline(lon, lat, elevation, dom, dist_search=5.0,
                          azim_num=16, ellps="sphere")
    out = pipe.run()
    assert out["hori"].shape[2] == 16
    assert out["hori"].shape[:2] == out["svf"].shape
    assert np.isfinite(out["svf"]).all()
    assert (out["svf"] > 0.5).all() and (out["svf"] <= 1.001).all()
    assert np.isfinite(out["slope"]).all()
    # The central bump produces positive horizon somewhere
    assert out["hori"].max() > np.deg2rad(1.0)


def test_curved_locations():
    """Per-location horizon on a curved mesh (auto-planarised)."""
    lat_wall = 45.0 + 0.03
    wall_h = 600.0

    def elev_fn(lon, lat):
        e = np.zeros_like(lon)
        e[np.abs(lat - lat_wall) < 0.002] = wall_h
        return e

    s = _curved_setup(elev_fn, n=100, dlat=0.002)
    n = 100
    vert_grid = auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"])
    i_obs, j_obs = 50, 50
    coords = np.array([[s["x"][i_obs, j_obs], s["y"][i_obs, j_obs],
                        s["z"][i_obs, j_obs]]], dtype=np.float32)
    vn = s["vec_norm"][i_obs:i_obs + 1, j_obs]
    vno = s["vec_north"][i_obs:i_obs + 1, j_obs]
    hori, azim = horizon.horizon_locations(
        vert_grid, n, n, coords, vn, vno, dist_search=8.0, azim_num=8,
        elev_ang_low_lim=-15.0)
    # Wall ~3.3 km north, 600 m high -> horizon toward north ~ atan(600/3300)
    d = 0.03 * 111.1e3
    expect = np.arctan(wall_h / d)
    assert abs(hori[0, 0] - expect) < np.deg2rad(1.0)
    # Other directions flat-ish
    assert abs(hori[0, 4]) < np.deg2rad(0.5)


@pytest.mark.parametrize("corner", ["south_east", "north_west"])
def test_curved_edge_box(corner):
    """An inner domain hugging the mesh edge: the planarised lattice box
    touches the lattice border.  The gridded horizon must agree with the
    per-location path within 0.3 deg at sampled cells."""
    def elev_fn(lon, lat):
        rng = np.random.default_rng(9)
        e = np.zeros_like(lon)
        for _ in range(6):
            clon = rng.uniform(lon.min(), lon.max())
            clat = rng.uniform(lat.min(), lat.max())
            sig = rng.uniform(0.004, 0.015)
            e += rng.uniform(100, 400) * np.exp(
                -(((lon - clon) ** 2 + (lat - clat) ** 2)
                  / (2 * sig ** 2)))
        return e

    s = _curved_setup(elev_fn, n=128, dlat=0.002)
    n = 128
    in0 = in1 = 24
    off = n - in0 - 2 if corner == "south_east" else 2
    in_sl = (slice(off, off + in0), slice(off, off + in1))
    vert_grid = auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"])
    kw = dict(dist_search=3.0, azim_num=8, hori_acc=0.25)
    hori, _ = horizon.horizon_gridded(
        vert_grid, n, n, s["vec_norm"][in_sl], s["vec_north"][in_sl],
        off, off, verbose=False, **kw)
    assert np.isfinite(hori).all()
    cells = [(0, 0), (in0 - 1, in1 - 1), (0, in1 - 1), (in0 // 2, 3),
             (in0 - 2, in1 // 2)]
    ii = np.array([c[0] for c in cells])
    jj = np.array([c[1] for c in cells])
    coords = np.stack([s["x"][off + ii, off + jj], s["y"][off + ii, off + jj],
                       s["z"][off + ii, off + jj]], axis=-1)
    h_loc, _ = horizon.horizon_locations(
        vert_grid, n, n, coords.astype(np.float32),
        s["vec_norm"][off + ii, off + jj], s["vec_north"][off + ii, off + jj],
        elev_ang_low_lim=-15.0, **kw)
    d = np.rad2deg(np.abs(hori[ii, jj] - h_loc))
    assert d.max() < 0.3, f"gridded vs locations {d.max():.3f} deg"

# Description: Shadow / shortwave-correction time track for a NASADEM
#              domain with a glacier (or any raster) mask — port
#              of examples/shadow/gridded_curved_DEM_NASADEM.py (Karakoram).
#              Masked cells are skipped (reference work-reduction pattern,
#              horizon_comp.cpp:749).
#
# Copyright (c) 2026
# MIT License

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..")))  # run without install


import numpy as np

import horayzon_tpu as hray
from horayzon_tpu import direction, sun_position, transform


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dem", nargs="*",
                    help="NASADEM NetCDF tiles (optional; needs xarray)")
    ap.add_argument("--out", default="/tmp/horayzon_tpu_out")
    ap.add_argument("--date", default="2026-07-01")
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    ap.add_argument("--steps", type=int, default=13)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    if args.dem:
        domain = {"lon_min": 76.3, "lon_max": 76.75,
                  "lat_min": 35.6, "lat_max": 35.95}
        domain_outer = hray.domain.curved_grid(domain, 25.0, ellps="WGS84")
        lon, lat, elevation = hray.load_dem.nasadem(args.dem, domain_outer)
        elevation = np.nan_to_num(elevation, nan=0.0).astype(np.float32)
    else:
        lon0, lat0, n, dlat = 76.5, 35.8, 600, 0.0012
        lat = lat0 + (np.arange(n)[::-1] - n / 2) * dlat
        lon = lon0 + (np.arange(n) - n / 2) * dlat
        rng = np.random.default_rng(9)
        lon2, lat2 = np.meshgrid(lon, lat)
        elevation = 4000.0 + np.zeros_like(lon2)
        for _ in range(25):
            clon = rng.uniform(lon.min(), lon.max())
            clat = rng.uniform(lat.min(), lat.max())
            sig = rng.uniform(0.008, 0.05)
            elevation += rng.uniform(400, 3500) * np.exp(
                -(((lon2 - clon) ** 2 + (lat2 - clat) ** 2)
                  / (2 * sig ** 2)))
        elevation = elevation.astype(np.float32)
        domain = {"lon_min": float(lon.min()) + 0.15,
                  "lon_max": float(lon.max()) - 0.15,
                  "lat_min": float(lat.min()) + 0.12,
                  "lat_max": float(lat.max()) - 0.12}

    lon_or = float(np.mean([domain["lon_min"], domain["lon_max"]]))
    lat_or = float(np.mean([domain["lat_min"], domain["lat_max"]]))
    trans = transform.TransformerEcef2enu(lon_or, lat_or, "WGS84")
    lon2, lat2 = np.meshgrid(lon, lat)
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elevation, "WGS84")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)

    sl = (slice(np.where(lat >= domain["lat_max"])[0][-1],
                np.where(lat <= domain["lat_min"])[0][0] + 1),
          slice(np.where(lon <= domain["lon_min"])[0][-1],
                np.where(lon >= domain["lon_max"])[0][0] + 1))
    vn_ecef = direction.surf_norm(lon2[sl], lat2[sl])
    vnorth_ecef = direction.north_dir(xe[sl], ye[sl], ze[sl], vn_ecef,
                                      "WGS84")
    vec_norm = transform.ecef2enu_vector(vn_ecef, trans)
    vec_north = transform.ecef2enu_vector(vnorth_ecef, trans)
    sl1 = (slice(sl[0].start - 1, sl[0].stop + 1),
           slice(sl[1].start - 1, sl[1].stop + 1))
    vec_tilt = np.ascontiguousarray(hray.topo_param.slope_vector_meth(
        x[sl1], y[sl1], z[sl1])[1:-1, 1:-1])
    surf_enl_fac = hray.topo_param.surface_enlargement_factor(
        vec_norm, vec_tilt)

    # "Glacier" mask: compute sw_dir_cor only on high, gentle terrain
    # (the reference rasterises GAMDAM polygons; any raster mask works)
    slope, _ = hray.topo_param.slope_angle_aspect(vec_tilt)
    mask = ((elevation[sl] > 4500.0)
            & (slope < np.deg2rad(40.0))).astype(np.uint8)
    print(f"masked-in cells: {mask.sum()} / {mask.size}")

    vert_grid = hray.auxiliary.rearrange_pad_buffer(x, y, z)
    terrain = hray.shadow.Terrain()
    terrain.initialise(vert_grid, elevation.shape[0], elevation.shape[1],
                       sl[0].start, sl[1].start, vec_tilt, vec_norm,
                       surf_enl_fac, np.ascontiguousarray(elevation[sl]),
                       mask, sw_dir_cor_fill=np.nan)

    times = [np.datetime64(args.date) + np.timedelta64(h, "h")
             for h in range(args.steps)]
    sun_enu = sun_position.sun_position_enu(times, trans)
    sw = terrain.sw_dir_cor_batch(sun_enu)
    m = np.nanmean(sw, axis=(1, 2))
    print("glacier-mean sw_dir_cor per step:",
          np.array2string(m, precision=2))
    np.savez_compressed(os.path.join(args.out, "sw_dir_cor_nasadem.npz"),
                        sw_dir_cor=sw, time=[str(t) for t in times],
                        mask=mask)
    print("saved:", os.path.join(args.out, "sw_dir_cor_nasadem.npz"))

    if args.plot:
        sys.path.insert(0, os.path.abspath(os.path.join(
            os.path.dirname(__file__), "..")))
        import plots_util
        plots_util.plot_frames(
            args.out, np.nan_to_num(sw, nan=0.0),
            titles=[str(t)[11:16] for t in times],
            name="sw_dir_cor_nasadem.png", vmax=2.0)


if __name__ == "__main__":
    main()

# Description: Compute topographic parameters for a coastal curved-Earth
#              domain with ocean masking — port of the reference
#              examples/horizon/gridded_curved_DEM_masked.py (South
#              Georgia).  Cells far from the coastline are masked out
#              (work reduction; reference horizon_comp.cpp:749) and receive
#              fill values.
#
# With shapely/fiona installed and network access, the GSHHG polygons can
# be used (hray.ocean_masking.get_gshhs_coastlines); the default path
# derives the land-sea mask from elevation and uses the built-in contour /
# KDTree machinery, which exercises the same code path.
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
from horayzon_tpu import direction, ocean_masking, transform


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/horayzon_tpu_out")
    ap.add_argument("--dist-coast", type=float, default=15.0,
                    help="coastline buffer [km]")
    ap.add_argument("--azim-num", type=int, default=60)
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    # Synthetic island (South-Georgia-like): elongated ridge in the ocean
    lon0, lat0, n, dlat = -36.5, -54.4, 500, 0.002
    lat = lat0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = lon0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    ridge = np.exp(-(((lon2 - lon0) * 0.7 + (lat2 - lat0)) ** 2 / 0.01)) \
        * np.exp(-((lon2 - lon0) ** 2 + (lat2 - lat0) ** 2) / 0.08)
    elevation = (2800.0 * ridge - 150.0).astype(np.float32)
    mask_land = elevation > 0.0
    elevation_dem = np.where(mask_land, elevation, 0.0).astype(np.float32)

    # ---- Ocean masking (reference pipeline, ocean_masking.py) -----------
    mask_bin = mask_land.astype(np.uint8)
    contours = ocean_masking.coastline_contours(lon, lat, mask_bin)
    print(f"coastline contours: {len(contours)} "
          f"({sum(len(c) for c in contours)} points)")
    pts_latlon = np.vstack(contours)
    h0 = np.zeros(len(pts_latlon), dtype=np.float32)
    pex, pey, pez = transform.lonlat2ecef(pts_latlon[:, 0],
                                          pts_latlon[:, 1], h0, "WGS84")
    pts_ecef = np.stack([pex, pey, pez], axis=-1)
    xe, ye, ze = transform.lonlat2ecef(
        lon2, lat2, np.zeros_like(elevation_dem), "WGS84")
    mask_buffer = ocean_masking.coastline_buffer(
        xe, ye, ze, mask_land, pts_ecef, lat, args.dist_coast * 1000.0,
        dlat, "WGS84")
    # Mask: 1 = compute (land or near-coast water), 0 = skip
    mask_sea_far = mask_buffer
    print("cells skipped by ocean mask: %.1f %%"
          % (100.0 * mask_sea_far.mean()))

    # ---- Geometry + horizon with mask -----------------------------------
    dom = {"lon_min": float(lon.min()) + 0.12,
           "lon_max": float(lon.max()) - 0.12,
           "lat_min": float(lat.min()) + 0.1,
           "lat_max": float(lat.max()) - 0.1}
    sl = (slice(np.where(lat >= dom["lat_max"])[0][-1],
                np.where(lat <= dom["lat_min"])[0][0] + 1),
          slice(np.where(lon <= dom["lon_min"])[0][-1],
                np.where(lon >= dom["lon_max"])[0][0] + 1))
    trans = transform.TransformerEcef2enu(
        float(np.mean([dom["lon_min"], dom["lon_max"]])),
        float(np.mean([dom["lat_min"], dom["lat_max"]])), "WGS84")
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elevation_dem, "WGS84")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)
    vn_ecef = direction.surf_norm(lon2[sl], lat2[sl])
    vnorth_ecef = direction.north_dir(xe[sl], ye[sl], ze[sl], vn_ecef,
                                      "WGS84")
    vec_norm = transform.ecef2enu_vector(vn_ecef, trans)
    vec_north = transform.ecef2enu_vector(vnorth_ecef, trans)
    vert_grid = hray.auxiliary.rearrange_pad_buffer(x, y, z)
    mask_in = (~mask_sea_far[sl]).astype(np.uint8)
    hori, azim = hray.horizon.horizon_gridded(
        vert_grid, n, n, vec_norm, vec_north, sl[0].start, sl[1].start,
        dist_search=15.0, azim_num=args.azim_num, mask=mask_in,
        hori_fill=0.0, verbose=False)
    print("horizon:", hori.shape,
          "computed fraction: %.1f %%" % (100.0 * mask_in.mean()))
    np.savez_compressed(os.path.join(args.out, "topo_par_masked.npz"),
                        horizon=hori, azim=azim, mask=mask_in)
    print("saved:", os.path.join(args.out, "topo_par_masked.npz"))

    if args.plot:
        sys.path.insert(0, os.path.abspath(os.path.join(
            os.path.dirname(__file__), "..")))
        import plots_util
        plots_util.plot_field(
            args.out, mask_in, "mask_masked.png",
            "Considered cells (ocean-masked domain)", cmap="gray")
        plots_util.plot_field(
            args.out, np.rad2deg(np.asarray(hori).mean(axis=-1)),
            "horizon_masked.png", "Azimuth-mean horizon [deg]")


if __name__ == "__main__":
    main()

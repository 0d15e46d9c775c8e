# Description: Shadow / shortwave-correction time track for an Antarctic
#              REMA domain in EPSG:3031 (polar stereographic) coordinates —
#              port of examples/shadow/gridded_curved_DEM_REMA.py.
#
#              The projected grid is planar in (x, y) but the surface
#              normals deviate from +z across the domain; the reference
#              handles this with per-cell ellipsoid normals, and so does
#              the Terrain engine (general per-cell-vector mode).
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
from horayzon_tpu import sun_position


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dem", help="REMA GeoTIFF tile (optional)")
    ap.add_argument("--out", default="/tmp/horayzon_tpu_out")
    ap.add_argument("--date", default="2026-12-21")
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    ap.add_argument("--steps", type=int, default=13)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    if args.dem:
        domain = {"x_min": -2132000.0, "x_max": -2093000.0,
                  "y_min": 1371000.0, "y_max": 1402000.0}
        domain_outer = hray.domain.planar_grid(domain, 25.0)
        x, y, elevation = hray.load_dem.rema(args.dem, domain_outer,
                                             engine="pillow")
        elevation = np.nan_to_num(elevation, nan=0.0).astype(np.float32)
    else:
        n, dxy = 600, 100.0
        x = -2100000.0 + np.arange(n, dtype=np.float32) * dxy
        y = 1400000.0 - np.arange(n, dtype=np.float32) * dxy
        rng = np.random.default_rng(7)
        xx, yy = np.meshgrid(x, y)
        elevation = np.zeros_like(xx)
        for _ in range(15):
            cx = rng.uniform(x.min(), x.max())
            cy = rng.uniform(y.min(), y.max())
            sig = rng.uniform(800, 6000)
            elevation += rng.uniform(200, 1800) * np.exp(
                -(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig ** 2)))
        elevation = elevation.astype(np.float32)
        pad = 8000.0
        domain = {"x_min": float(x.min()) + pad,
                  "x_max": float(x.max()) - pad,
                  "y_min": float(y.min()) + pad,
                  "y_max": float(y.max()) - pad}

    sl = (slice(np.where(y >= domain["y_max"])[0][-1],
                np.where(y <= domain["y_min"])[0][0] + 1),
          slice(np.where(x <= domain["x_min"])[0][-1],
                np.where(x >= domain["x_max"])[0][0] + 1))
    in_shape = (sl[0].stop - sl[0].start, sl[1].stop - sl[1].start)

    xx, yy = np.meshgrid(x, y)
    # Planar treatment of the projected grid (like the reference, which
    # works in the projected frame with upward normals for REMA's high-
    # latitude, small-extent domains)
    vec_norm = np.zeros(in_shape + (3,), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    sl1 = (slice(sl[0].start - 1, sl[0].stop + 1),
           slice(sl[1].start - 1, sl[1].stop + 1))
    vec_tilt = np.ascontiguousarray(hray.topo_param.slope_plane_meth(
        xx[sl1], yy[sl1], elevation[sl1])[1:-1, 1:-1])
    surf_enl_fac = hray.topo_param.surface_enlargement_factor(
        vec_norm, vec_tilt)
    vert_grid = hray.auxiliary.rearrange_pad_buffer(xx, yy, elevation)
    mask = np.ones(in_shape, dtype=np.uint8)

    terrain = hray.shadow.Terrain()
    terrain.initialise(vert_grid, elevation.shape[0], elevation.shape[1],
                       sl[0].start, sl[1].start, vec_tilt, vec_norm,
                       surf_enl_fac, np.ascontiguousarray(elevation[sl]),
                       mask)

    # Antarctic summer sun track: azimuth/elevation at ~-75 S
    times = [np.datetime64(args.date) + np.timedelta64(2 * h, "h")
             for h in range(args.steps)]
    az, el = sun_position.sun_azimuth_elevation(times, lon=-70.0,
                                                lat=-75.0)
    sun_positions = sun_position.sun_position_planar(az, el, dist=1.0e8)
    sw = terrain.sw_dir_cor_batch(sun_positions)
    print("sun elevation per step [deg]:",
          np.array2string(el, precision=1))
    print("domain-mean sw_dir_cor:",
          np.array2string(sw.mean(axis=(1, 2)), precision=2))
    np.savez_compressed(os.path.join(args.out, "sw_dir_cor_rema.npz"),
                        sw_dir_cor=sw, time=[str(t) for t in times])
    print("saved:", os.path.join(args.out, "sw_dir_cor_rema.npz"))

    if args.plot:
        sys.path.insert(0, os.path.abspath(os.path.join(
            os.path.dirname(__file__), "..")))
        import plots_util
        plots_util.plot_frames(
            args.out, sw, titles=[str(t)[11:16] for t in times],
            name="sw_dir_cor_rema.png", vmax=2.0)


if __name__ == "__main__":
    main()

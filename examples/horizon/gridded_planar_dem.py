# Description: Compute gridded topographic parameters (slope angle and
#              aspect, horizon and sky view factor) from a planar DEM —
#              the port of the reference workflow
#              examples/horizon/gridded_planar_DEM.py (swisstopo DHM25).
#
# With network access, pass --dem <DHM25 .asc file> to run on real data;
# without arguments a synthetic Alpine-like terrain is generated so the
# script runs end-to-end in any environment.
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


def synthetic_dhm25_like(n=1600, dx=25.0, seed=0):
    """Alps-like synthetic terrain: ridges + valleys, 25 m grid."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) * dx
    z = np.zeros((n, n))
    for _ in range(40):
        cx, cy = rng.uniform(0, n * dx, 2)
        sig = rng.uniform(20, 160) * dx
        amp = rng.uniform(200, 1800)
        z += amp * np.exp(-(((x - cx) ** 2 + (y - cy) ** 2)
                            / (2 * sig ** 2)))
    z += 120.0 * np.sin(x / 2100.0) * np.cos(y / 1700.0)
    x1 = np.arange(n) * dx
    y1 = (n - 1 - np.arange(n)) * dx  # north-up (descending y)
    return x1.astype(np.float32), y1.astype(np.float32), \
        z.astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dem", help="DHM25 ESRI ASCII GRID file (optional)")
    ap.add_argument("--out", default="/tmp/horayzon_tpu_out")
    ap.add_argument("--dist-search", type=float, default=20.0)
    ap.add_argument("--azim-num", type=int, default=180)
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    # ---- Load DEM (reference: hray.load_dem.dhm25) ----------------------
    if args.dem:
        # Domain of the reference example (gridded_planar_DEM.py:24-26)
        domain = {"x_min": 668000, "x_max": 707000,
                  "y_min": 172000, "y_max": 200000}
        domain_outer = hray.domain.planar_grid(domain, args.dist_search)
        x, y, elevation = hray.load_dem.dhm25(args.dem, domain_outer,
                                              engine="numpy")
        elevation = np.nan_to_num(elevation, nan=0.0)
    else:
        # size the synthetic grid so the inner domain stays ~800^2 after
        # the search-distance pad (a 20 km search at 25 m costs 800 cells
        # per side)
        n = 2 * int(args.dist_search * 1000.0 / 25.0) + 800
        x, y, elevation = synthetic_dhm25_like(n=n)
        pad = args.dist_search * 1000.0
        domain = {"x_min": float(x.min()) + pad,
                  "x_max": float(x.max()) - pad,
                  "y_min": float(y.min()) + pad,
                  "y_max": float(y.max()) - pad}

    # ---- Pipeline (domain -> horizon -> SVF -> slope) -------------------
    pipe = hray.models.PlanarPipeline(
        x, y, elevation, domain, dist_search=args.dist_search,
        azim_num=args.azim_num)
    out = pipe.run()

    print("horizon:", out["hori"].shape,
          "range [deg]: %.2f .. %.2f" % (np.rad2deg(out["hori"].min()),
                                         np.rad2deg(out["hori"].max())))
    print("svf range: %.3f .. %.3f" % (out["svf"].min(), out["svf"].max()))

    # ---- Save (reference writes NetCDF; .npz needs no optional deps) ----
    np.savez_compressed(
        os.path.join(args.out, "topo_par_planar.npz"),
        horizon=out["hori"], azim=out["azim"], svf=out["svf"],
        slope=out["slope"], aspect=out["aspect"],
        elevation=out["elevation"], x=out["x"], y=out["y"])
    print("saved:", os.path.join(args.out, "topo_par_planar.npz"))

    if args.plot:
        sys.path.insert(0, os.path.abspath(os.path.join(
            os.path.dirname(__file__), "..")))
        import plots_util
        plots_util.plot_topo_panels(
            args.out, elevation=out["elevation"], svf=out["svf"],
            slope=out["slope"], hori=out["hori"], azim=out["azim"],
            name="topo_panels_planar.png")


if __name__ == "__main__":
    main()

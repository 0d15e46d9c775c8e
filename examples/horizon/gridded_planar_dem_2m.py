# Description: Terrain horizon and sky view factor for a very high
#              resolution (2 m) planar DEM with a multi-resolution far
#              field — port of the reference workflow
#              examples/horizon/gridded_planar_DEM_2m.py (swissALTI3D).
#
#              The reference decimates the outer domain into a simplified
#              TIN with the external `hmm` tool under a vertical error
#              budget and attaches it to the Embree scene (:130-265).  Here
#              the far field is the same DEM max-pooled to coarse cells and
#              fed to the sweep as upper mip levels (ops/multires.py) — the
#              same two-component accuracy budget, no external tool, no
#              skirt geometry.
#
# Pass --dem-dir <swissALTI3D tile dir> for real data; default synthetic.
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
from horayzon_tpu.ops import multires


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dem-dir", help="swissALTI3D tile directory")
    ap.add_argument("--out", default="/tmp/horayzon_tpu_out")
    ap.add_argument("--dist-search", type=float, default=20.0,
                    help="search distance [km]")
    ap.add_argument("--azim-num", type=int, default=60)
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    ap.add_argument("--inner", type=int, default=1024,
                    help="inner cells per side at 2 m")
    ap.add_argument("--ratio-log2", type=int, default=4,
                    help="log2 of far-field coarsening (2 m -> 32 m)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    dx = 2.0
    r = 2 ** args.ratio_log2
    # Fine grid must cover the inner domain + the halo marched at fine
    # levels (validated by horizon_sweep_multires)
    halo_fine = 2048
    n_fine = args.inner + 2 * halo_fine

    if args.dem_dir:
        x0, y0 = 2669000.0, 1241000.0  # LV95 (reference :27-29)
        dom_fine = {"x_min": x0, "x_max": x0 + n_fine * dx,
                    "y_min": y0, "y_max": y0 + n_fine * dx}
        xf, yf, z_fine = hray.load_dem.swissalti3d(args.dem_dir, dom_fine)
        dom_coarse = hray.domain.planar_grid(
            {"x_min": x0 + halo_fine * dx,
             "x_max": x0 + (halo_fine + args.inner) * dx,
             "y_min": y0 + halo_fine * dx,
             "y_max": y0 + (halo_fine + args.inner) * dx},
            args.dist_search)
        xc, yc, z_coarse_full = hray.load_dem.swissalti3d(args.dem_dir,
                                                          dom_coarse)
        # max-pool to the coarse spacing
        hh = z_coarse_full.shape[0] - z_coarse_full.shape[0] % r
        ww = z_coarse_full.shape[1] - z_coarse_full.shape[1] % r
        z_coarse = z_coarse_full[:hh, :ww] \
            .reshape(hh // r, r, ww // r, r).max(axis=(1, 3))
        coarse_offset = (0, 0)  # fine grid starts at the coarse origin
    else:
        # Synthetic 2 m alpine terrain over the full coarse extent
        rng = np.random.default_rng(2)
        n_coarse = int(np.ceil((n_fine * dx + 2 * args.dist_search * 1000.0)
                               / (r * dx)))
        yy, xx = np.mgrid[0:n_coarse, 0:n_coarse].astype(np.float64)
        zc = np.zeros((n_coarse, n_coarse))
        for _ in range(30):
            cy, cx = rng.uniform(0, n_coarse, 2)
            sig = rng.uniform(10, n_coarse / 6)
            zc += rng.uniform(200, 2000) * np.exp(
                -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
        z_coarse = zc.astype(np.float32)
        # Fine grid: upsample the coarse window + add 2 m-scale detail
        fo_c = (n_coarse - n_fine // r) // 2
        fo_c -= fo_c % 1
        window = z_coarse[fo_c:fo_c + n_fine // r,
                          fo_c:fo_c + n_fine // r]
        z_fine = np.repeat(np.repeat(window, r, 0), r, 1)
        z_fine = z_fine + 3.0 * rng.standard_normal(z_fine.shape) \
            .astype(np.float32)
        z_fine = z_fine.astype(np.float32)
        coarse_offset = (fo_c * r, fo_c * r)

    off = halo_fine
    inner = (args.inner, args.inner)
    print(f"fine grid {z_fine.shape} @ {dx} m, "
          f"coarse {z_coarse.shape} @ {r * dx} m")
    kw = dict(ratio_log2=args.ratio_log2, coarse_offset=coarse_offset,
              dx=dx, dy=-dx, offset=(off, off), inner_shape=inner,
              dist_search=args.dist_search * 1000.0, hori_acc=0.25)
    azim = (2 * np.pi / args.azim_num) * np.arange(args.azim_num)
    hori = multires.horizon_sweep_multires(z_fine, z_coarse, azim=azim,
                                           **kw)
    import jax.numpy as jnp
    print("horizon mean [deg]: %.2f, max [deg]: %.2f"
          % (float(jnp.rad2deg(jnp.mean(hori))),
             float(jnp.rad2deg(jnp.max(hori)))))
    # Save the per-azimuth domain mean only (the full field is large)
    np.savez_compressed(
        os.path.join(args.out, "hori_2m_summary.npz"),
        hori_mean_per_azim=np.asarray(jnp.mean(hori, axis=(0, 1))),
        azim=azim)
    print("saved:", os.path.join(args.out, "hori_2m_summary.npz"))

    if args.plot:
        sys.path.insert(0, os.path.abspath(os.path.join(
            os.path.dirname(__file__), "..")))
        import plots_util
        plots_util.plot_location_horizons(
            args.out, np.asarray(jnp.mean(hori, axis=(0, 1)))[None, :],
            azim, ["domain mean"], name="horizon_2m_mean.png")


if __name__ == "__main__":
    main()

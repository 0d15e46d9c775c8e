# Description: Compute the gridded correction factor for downward direct
#              shortwave radiation from artificial topography (hemispherical
#              mountain, rotating sun) and check the spatial mean against
#              the analytic expectation (~1).  Port of the
#              reference examples/shadow/gridded_planar_DEM_artificial.py.
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


def hemisphere_terrain(dx):
    """Artificial topography (reference :45-99): hemisphere of radius
    0.95 * 10 km in a 40 km padded domain, initialised as a Terrain.

    Returns ``(terrain, elevation_inner, surf_enl_fac)``."""
    dom_width_h = np.array([10000, 20000, 10000], dtype=np.float32)
    dy = dx
    x = np.linspace(-(dom_width_h.sum() - dx / 2),
                    dom_width_h.sum() - dx / 2,
                    int(dom_width_h.sum() / dx) * 2, dtype=np.float32)
    y = x[::-1].copy()
    xx, yy = np.meshgrid(x, y)
    slice_in = (slice(int(dom_width_h[2] / dy), -int(dom_width_h[2] / dy)),
                slice(int(dom_width_h[2] / dx), -int(dom_width_h[2] / dx)))
    elevation = np.zeros(xx.shape, dtype=np.float32)
    sl_mod = (slice(int(dom_width_h[1:].sum() / dy),
                    -int(dom_width_h[1:].sum() / dy)),
              slice(int(dom_width_h[1:].sum() / dx),
                    -int(dom_width_h[1:].sum() / dx)))
    rad_sqrt = (dom_width_h[0] * 0.95) ** 2
    with np.errstate(invalid="ignore"):
        elevation[sl_mod] = np.sqrt(rad_sqrt - xx[sl_mod] ** 2
                                    - yy[sl_mod] ** 2)
    elevation[np.isnan(elevation)] = 0.0
    print("Inner domain size:", elevation[slice_in].shape)

    # Vectors / surface enlargement (reference :66-99)
    in_shape = elevation[slice_in].shape
    vec_norm = np.zeros(in_shape + (3,), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    sl1 = (slice(slice_in[0].start - 1, slice_in[0].stop + 1),
           slice(slice_in[1].start - 1, slice_in[1].stop + 1))
    vec_tilt = np.ascontiguousarray(hray.topo_param.slope_plane_meth(
        xx[sl1], yy[sl1], elevation[sl1])[1:-1, 1:-1])
    surf_enl_fac = hray.topo_param.surface_enlargement_factor(vec_norm,
                                                              vec_tilt)
    print("Surface enlargement factor (min/max): %.3f, %.3f"
          % (surf_enl_fac.min(), surf_enl_fac.max()))

    vert_grid = hray.auxiliary.rearrange_pad_buffer(xx, yy, elevation)
    mask = np.ones(in_shape, dtype=np.uint8)
    terrain = hray.shadow.Terrain()
    terrain.initialise(vert_grid, elevation.shape[0], elevation.shape[1],
                       slice_in[0].start, slice_in[1].start,
                       vec_tilt, vec_norm, surf_enl_fac,
                       np.ascontiguousarray(elevation[slice_in]), mask,
                       ang_max=89.99)
    return terrain, elevation[slice_in], surf_enl_fac


def rotating_sun(azim_steps, elev):
    """Rotating sun (reference :107-112): (azimuths [rad], positions)."""
    azim = np.deg2rad(np.linspace(0.0, 360.0, azim_steps))
    return azim, hray.sun_position.sun_position_planar(
        np.rad2deg(azim), elev, dist=1.0e7)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/horayzon_tpu_out")
    ap.add_argument("--dx", type=float, default=100.0)
    ap.add_argument("--azim-steps", type=int, default=181)
    ap.add_argument("--elev", type=float, default=30.0)
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    terrain, elevation_in, surf_enl_fac = hemisphere_terrain(args.dx)
    # all time steps in ONE device call
    azim, sun_positions = rotating_sun(args.azim_steps, args.elev)
    sw = terrain.sw_dir_cor_batch(sun_positions)
    means = sw.mean(axis=(1, 2))
    print("spatial-mean sw_dir_cor: min %.3f max %.3f average %.3f "
          "(analytic expectation ~1)"
          % (means.min(), means.max(), means.mean()))

    np.savez_compressed(
        os.path.join(args.out, "sw_dir_cor_artificial.npz"),
        sw_dir_cor=sw, azim=np.rad2deg(azim),
        elevation=elevation_in, surf_enl_fac=surf_enl_fac)
    print("saved:", os.path.join(args.out, "sw_dir_cor_artificial.npz"))

    if args.plot:
        sys.path.insert(0, os.path.abspath(os.path.join(
            os.path.dirname(__file__), "..")))
        import plots_util
        plots_util.plot_series(
            args.out, np.rad2deg(azim), means,
            xlabel="Sun azimuth [deg]",
            ylabel="Spatial-mean sw_dir_cor [-]",
            name="sw_dir_cor_artificial_mean.png", hline=1.0,
            title="Artificial hemisphere: analytic expectation ~1")
        plots_util.plot_frames(args.out, sw,
                               name="sw_dir_cor_artificial.png", vmax=2.0)


if __name__ == "__main__":
    main()

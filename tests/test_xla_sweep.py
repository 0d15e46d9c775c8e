"""The XLA shifted-slice sweep against the brute-force oracle.

Covers the azimuth counts, search distances and geometry modes the sweep
supports: odd and prime azimuth counts, distances that stay in the dense
near field and distances that reach the max-mip far field, and tilted
per-cell tangent frames (general mode).
"""

import numpy as np
import pytest

from horayzon_tpu import terrain as _terrain
from horayzon_tpu.ops import sweep

from reference_impl import (brute_horizon, brute_horizon_general,
                            gaussian_bumps_terrain, tilted_vectors)

DX = 25.0
INNER = (6, 6)


def _azim(n):
    return (2 * np.pi / n) * np.arange(n)


@pytest.mark.parametrize("dist", [600.0, 7000.0], ids=["near", "mip"])
@pytest.mark.parametrize("azim_num", [7, 13, 33, 90])
def test_sweep_matches_bruteforce(azim_num, dist):
    """Max error within the hori_acc contract (0.25 deg) plus the oracle's
    own sampling error (it point-samples at a quarter cell)."""
    halo = int(dist / DX) + 4
    n = INNER[0] + 2 * halo
    z = gaussian_bumps_terrain(n, n, seed=azim_num, amp=350.0, n_bumps=12)
    azim = _azim(azim_num)
    sched = sweep.build_schedule(DX, dist, sweep.default_rel_err(0.25))
    assert (max(p.level for p in sched.phases) > 0) == (dist > 6000.0)
    hori, _ = sweep.horizon_sweep(
        z, dx=DX, dy=-DX, offset=(halo, halo), inner_shape=INNER,
        azim=azim, dist_search=dist, hori_acc=0.25)
    oracle = brute_horizon(z, DX, -DX, (halo, halo), INNER, azim, dist,
                           step_frac=0.25)
    err = np.rad2deg(np.abs(np.asarray(hori) - oracle))
    assert err.max() < 0.3, f"max horizon error {err.max():.3f} deg"
    assert np.median(err) < 0.05


@pytest.mark.parametrize("tilt_deg", [1.0, 5.0, 15.0])
def test_general_geometry_matches_bruteforce(tilt_deg):
    """Tilted tangent frames: the general-mode sweep measures angles in each
    cell's local frame while marching the domain-mean direction."""
    dist = 1200.0
    halo = int(dist / DX) + 4
    n = INNER[0] + 2 * halo
    z = gaussian_bumps_terrain(n, n, seed=5, amp=350.0, n_bumps=10)
    azim = _azim(16)
    vn, vno = tilted_vectors(INNER, tilt_deg)
    geom = _terrain.basis_fields(vn, vno)
    u_xy = _terrain.mean_marching_directions(azim, vn, vno)
    hori, _ = sweep.horizon_sweep(
        z, dx=DX, dy=-DX, offset=(halo, halo), inner_shape=INNER,
        azim=azim, dist_search=dist, hori_acc=0.25, geom=geom, u_xy=u_xy)
    oracle = brute_horizon_general(z, DX, -DX, (halo, halo), INNER, azim,
                                   u_xy, vn, vno, dist, step_frac=0.25)
    err = np.rad2deg(np.abs(np.asarray(hori) - oracle))
    assert err.max() < 0.3, f"max horizon error {err.max():.3f} deg"
    # the tilt really changes the answer
    planar, _ = sweep.horizon_sweep(
        z, dx=DX, dy=-DX, offset=(halo, halo), inner_shape=INNER,
        azim=azim, dist_search=dist, hori_acc=0.25)
    shift = np.rad2deg(np.abs(np.asarray(planar) - oracle)).max()
    assert shift > 0.5 * tilt_deg

"""Masked runs equal the dense run on every unmasked cell.

The sweep is cropped to the bounding box of unmasked cells (the reference
skips masked cells, horizon_comp.cpp:749); masked cells get ``hori_fill``.
Mask shapes: a centred disc, a compact island, scattered glacier-style
patches, a band whose box starts at the origin and is shorter than the
inner domain, and an all-masked domain — on a planar grid and on a curved
(lon/lat) mesh.
"""

import numpy as np
import pytest

from horayzon_tpu import auxiliary, horizon

from reference_impl import gaussian_bumps_terrain
from test_curved import _curved_setup

IN = 32
FILL = -9.0


def _mask(kind):
    yy, xx = np.mgrid[0:IN, 0:IN]
    if kind == "disc":
        m = (yy - 15.0) ** 2 + (xx - 17.0) ** 2 <= 8.0 ** 2
    elif kind == "island":
        m = ((yy - 16.0) / 7.0) ** 2 + ((xx - 16.0) / 3.5) ** 2 <= 1.0
    elif kind == "scattered":
        rng = np.random.default_rng(7)
        m = np.zeros((IN, IN), bool)
        for _ in range(6):
            cy, cx = rng.uniform(0, IN, 2)
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.uniform(1.5, 3.0) ** 2
    elif kind == "origin_bbox":
        m = np.zeros((IN, IN), bool)
        m[:9, :20] = True
    else:
        assert kind == "all_zero"
        m = np.zeros((IN, IN), bool)
    return m.astype(np.uint8)


def _planar_case():
    z = gaussian_bumps_terrain(96, 96, seed=9, amp=300.0)
    x = np.arange(96, dtype=np.float32) * 25.0
    y = -np.arange(96, dtype=np.float32) * 25.0
    xx, yy = np.meshgrid(x, y)
    vg = auxiliary.rearrange_pad_buffer(xx, yy, z)
    vn = np.zeros((IN, IN, 3), np.float32)
    vn[..., 2] = 1.0
    vno = np.zeros((IN, IN, 3), np.float32)
    vno[..., 1] = 1.0
    return (vg, 96, 96, vn, vno, 32, 32), dict(dist_search=0.6)


def _curved_case():
    def elev_fn(lon, lat):
        rng = np.random.default_rng(4)
        e = np.zeros_like(lon)
        for _ in range(8):
            clon = rng.uniform(lon.min(), lon.max())
            clat = rng.uniform(lat.min(), lat.max())
            sig = rng.uniform(0.004, 0.02)
            e += rng.uniform(100, 500) * np.exp(
                -(((lon - clon) ** 2 + (lat - clat) ** 2) / (2 * sig ** 2)))
        return e

    s = _curved_setup(elev_fn, n=128, dlat=0.002)
    off = 48
    sl = (slice(off, off + IN), slice(off, off + IN))
    vg = auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"])
    return ((vg, 128, 128, np.ascontiguousarray(s["vec_norm"][sl]),
             np.ascontiguousarray(s["vec_north"][sl]), off, off),
            dict(dist_search=3.0))


_CASES = {"planar": _planar_case, "curved": _curved_case}


def _run(geometry, mask=None):
    args, kw = _CASES[geometry]()
    return horizon.horizon_gridded(*args, azim_num=8, hori_acc=0.25,
                                   mask=mask, hori_fill=FILL, verbose=False,
                                   **kw)[0]


@pytest.fixture(scope="module")
def dense_runs():
    return {geometry: _run(geometry) for geometry in _CASES}


@pytest.mark.parametrize("kind", ["disc", "island", "scattered",
                                  "origin_bbox", "all_zero"])
@pytest.mark.parametrize("geometry", ["planar", "curved"])
def test_masked_equals_dense_on_unmasked_cells(dense_runs, geometry, kind):
    dense = dense_runs[geometry]
    mask = _mask(kind)
    got = _run(geometry, mask)
    sel = mask == 1
    assert got.shape == dense.shape
    assert (got[~sel] == FILL).all()
    if sel.any():
        d = np.rad2deg(np.abs(got[sel] - dense[sel]))
        # the crop changes only which dense samples are known to stay on
        # the grid (and, curved, the crop's mean marching direction)
        assert d.max() < 0.25, f"max diff {d.max():.4f} deg"
        assert np.median(d) < 1e-3

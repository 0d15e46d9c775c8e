# Copyright (c) 2026
# MIT License
"""Ocean masking: coastline selection, contour tracing, distance buffers.

Functional equivalent of the reference's ocean-masking module
(``horayzon/ocean_masking.py:23,112,163,217``).  Masking is a *work
reduction* device: cells beyond the coastline buffer are skipped by the
horizon engine (the sweep is cropped to the unmasked bounding box,
mirroring reference horizon_comp.cpp:749).

Design notes (vs the reference):

* Polygon candidate selection uses a plain vectorised bounding-box overlap
  test over the cached bounds table — no spatial index library needed for
  a one-shot rectangular query.
* Contour tracing maps ``skimage.find_contours`` index coordinates to
  lon/lat with the grid's linear transform directly; a pure-NumPy
  edge-midpoint tracer stands in when scikit-image is missing.
* The buffer classifies whole blocks by the triangle inequality
  (centre distance +- the block's maximal chord radius) and refines only
  the ambiguous shell per-cell, so its output is exactly the per-cell
  answer at a fraction of the query cost.

Optional dependencies (gated at call time): ``fiona`` + ``shapely`` for
GSHHG polygons, ``scikit-image`` for sub-cell contours.  Distance queries
use :class:`scipy.spatial.KDTree`.
"""

import os
import shutil
import time
import zipfile

import numpy as np
from scipy.spatial import KDTree

from horayzon_tpu import transform
from horayzon_tpu.auxiliary import get_path_aux_data
from horayzon_tpu.download import file as _download_file

_GSHHG_URL = ("http://www.soest.hawaii.edu/pwessel/gshhg/"
              "gshhg-shp-2.3.7.zip")
#: full-resolution level-1 (continents + islands) shapefile inside GSHHG
_GSHHG_SHP = os.path.join("GSHHS_shp", "f", "GSHHS_f_L1.shp")
_BOUNDS_CACHE = "polygon_bounds_L1f.npy"


# ---------------------------------------------------------------------------
# GSHHG coastline polygons
# ---------------------------------------------------------------------------

def _gshhg_root():
    """Path of the cached GSHHG extraction; downloads it on first use and
    drops the unused resolutions/layers to save disk."""
    root = os.path.join(get_path_aux_data(), "GSHHG")
    if not os.path.isdir(root):
        aux = get_path_aux_data()
        print("Download GSHHG data:")
        _download_file(_GSHHG_URL, aux)
        archive = os.path.join(aux, _GSHHG_URL.rsplit("/", 1)[-1])
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(root)
        os.remove(archive)
        for sub in ("WDBII_shp", os.path.join("GSHHS_shp", "h"),
                    os.path.join("GSHHS_shp", "i")):
            shutil.rmtree(os.path.join(root, sub), ignore_errors=True)
    return root


def _polygon_bounds(shp_path, cache_path):
    """(N, 4) lon/lat bounds of every polygon in the shapefile, cached to
    ``.npy`` next to the data (building it reads all ~180k geometries)."""
    if os.path.isfile(cache_path):
        return np.load(cache_path)
    import fiona
    from shapely.geometry import shape
    with fiona.open(shp_path) as src:
        table = np.empty((len(src), 4), dtype=np.float64)
        for k, rec in enumerate(src):
            table[k] = shape(rec["geometry"]).bounds
    np.save(cache_path, table)
    return table


def get_gshhs_coastlines(domain):
    """GSHHS level-1 coastline polygons intersecting a lon/lat domain.

    Behavioural equivalent of reference ocean_masking.py:23-108.  The
    GSHHG archive is fetched once; candidate polygons are pre-selected
    with a vectorised bounding-box overlap test and then cropped to the
    domain rectangle.

    Parameters
    ----------
    domain : dict with ``lon_min, lon_max, lat_min, lat_max`` [deg]

    Returns
    -------
    list of shapely polygons (cropped to the domain)
    """
    try:
        import fiona
        from shapely.geometry import box, shape
    except ImportError as exc:
        raise ImportError("get_gshhs_coastlines requires the optional "
                          "dependencies 'fiona' and 'shapely'") from exc

    missing = {"lon_min", "lon_max", "lat_min", "lat_max"} \
        - set(domain.keys())
    if missing:
        raise ValueError("one or multiple key(s) are missing in 'domain'")
    if (domain["lon_min"] >= domain["lon_max"]
            or domain["lat_min"] >= domain["lat_max"]):
        raise ValueError("invalid domain extent")

    root = _gshhg_root()
    shp = os.path.join(root, _GSHHG_SHP)
    bounds = _polygon_bounds(shp, os.path.join(root, _BOUNDS_CACHE))

    # Rectangle overlap: polygon bbox (x0, y0, x1, y1) vs the query box.
    hit = ((bounds[:, 0] <= domain["lon_max"])
           & (bounds[:, 2] >= domain["lon_min"])
           & (bounds[:, 1] <= domain["lat_max"])
           & (bounds[:, 3] >= domain["lat_min"]))
    idx = np.nonzero(hit)[0]
    print("Number of polygons: " + str(len(idx)))

    window = box(domain["lon_min"], domain["lat_min"],
                 domain["lon_max"], domain["lat_max"])
    clipped = []
    with fiona.open(shp) as src:
        for k in idx:
            poly = shape(src[int(k)]["geometry"])
            if window.contains(poly):
                clipped.append(poly)
            elif window.intersects(poly):
                clipped.append(window.intersection(poly))
    return clipped


# ---------------------------------------------------------------------------
# Coastline contours from a land-sea mask
# ---------------------------------------------------------------------------

def _transition_midpoints(lon, lat, land):
    """NumPy stand-in for sub-cell contour tracing: midpoints of all grid
    edges whose endpoints differ in the mask.  Unordered, but equivalent
    for nearest-distance queries."""
    chunks = []
    flip_w = land[:, 1:] != land[:, :-1]        # west-east neighbours
    r, c = np.nonzero(flip_w)
    if r.size:
        chunks.append(np.column_stack(
            [0.5 * (lon[c] + lon[c + 1]), lat[r]]))
    flip_s = land[1:, :] != land[:-1, :]        # south-north neighbours
    r, c = np.nonzero(flip_s)
    if r.size:
        chunks.append(np.column_stack(
            [lon[c], 0.5 * (lat[r] + lat[r + 1])]))
    return [np.concatenate(chunks, axis=0)] if chunks else []


def coastline_contours(lon, lat, mask_bin):
    """Coastline contour polylines of a binary land-sea mask.

    Behavioural equivalent of reference ocean_masking.py:112-160: contours
    of the 0.5 level, returned as (N, 2) lon/lat arrays.  Index
    coordinates from ``skimage.measure.find_contours`` are mapped through
    the grid's linear transform; without scikit-image an edge-midpoint
    point cloud is returned instead (same use: distance queries).
    """
    lon = np.asarray(lon)
    lat = np.asarray(lat)
    mask_bin = np.asarray(mask_bin)
    if lon.ndim != 1 or lat.ndim != 1:
        raise ValueError("Input coordinates arrays must be 1-dimensional")
    if mask_bin.shape != (lat.size, lon.size):
        raise ValueError("Input data has inconsistent dimension length(s)")
    levels = np.unique(mask_bin)
    if (mask_bin.dtype != np.uint8 or levels.size != 2
            or not np.array_equal(levels, [0, 1])):
        raise ValueError("'mask_bin' must be of type 'uint8' and may only "
                         "contain 0 and 1")

    try:
        from skimage.measure import find_contours
    except ImportError:
        return _transition_midpoints(lon, lat, mask_bin.astype(bool))

    d_lon = (lon[-1] - lon[0]) / (lon.size - 1)
    d_lat = (lat[-1] - lat[0]) / (lat.size - 1)
    polylines = []
    for path in find_contours(mask_bin, 0.5, fully_connected="high"):
        pts = np.empty_like(path)
        pts[:, 0] = lon[0] + path[:, 1] * d_lon    # column -> lon
        pts[:, 1] = lat[0] + path[:, 0] * d_lat    # row -> lat
        polylines.append(pts)
    return polylines


# ---------------------------------------------------------------------------
# Chord distances and the buffer mask
# ---------------------------------------------------------------------------

def coastline_distance(x_ecef, y_ecef, z_ecef, mask_land, pts_ecef):
    """Minimal chord (straight-line ECEF) distance of every water cell to
    the coastline point set; land cells get NaN.

    Behavioural equivalent of reference ocean_masking.py:163-214."""
    x_ecef = np.asarray(x_ecef)
    mask_land = np.asarray(mask_land)
    if x_ecef.shape != mask_land.shape:
        raise ValueError("Input data has inconsistent dimension length(s)")
    if mask_land.dtype != np.bool_:
        raise ValueError("'mask_land' must be a boolean mask")
    water = ~mask_land
    queries = np.column_stack([np.asarray(a)[water]
                               for a in (x_ecef, y_ecef, z_ecef)])
    out = np.full(x_ecef.shape, np.nan)
    if queries.size:
        out[water] = KDTree(pts_ecef).query(queries, k=1, workers=-1)[0]
    return out


def _block_chord_radius(lat, dem_res, half, ellps):
    """Upper bound on the chord distance from a block centre to any cell
    of a (2*half+1)^2 block, evaluated at the domain's most-equatorward
    latitude (where a degree of longitude is longest)."""
    lat0 = max(np.abs(lat).min() - 1.0, 0.0)
    span = dem_res * half
    ax, ay, az = transform.lonlat2ecef(
        np.array([0.0]), np.array([lat0]), np.zeros(1, np.float32),
        ellps=ellps)
    bx, by, bz = transform.lonlat2ecef(
        np.array([span]), np.array([lat0 + span]), np.zeros(1, np.float32),
        ellps=ellps)
    return float(np.sqrt((ax - bx) ** 2 + (ay - by) ** 2
                         + (az - bz) ** 2)[0])


def coastline_buffer(x_ecef, y_ecef, z_ecef, mask_land, pts_ecef, lat,
                     dist_thr, dem_res, ellps, block_size=11):
    """True where a cell lies farther than ``dist_thr`` from the coastline
    (i.e. can be excluded from terrain computations); land cells are
    always False.

    Behavioural equivalent of reference ocean_masking.py:217-345.  Blocks
    of ``block_size x block_size`` cells are classified with one centre
    query via the triangle inequality; only the ambiguous shell (centre
    distance within one block radius of the threshold) is refined with
    per-cell queries, so the result equals the exhaustive per-cell answer.
    """
    arrays = [np.asarray(a) for a in (x_ecef, y_ecef, z_ecef)]
    x_ecef, y_ecef, z_ecef = arrays
    mask_land = np.asarray(mask_land)
    lat = np.asarray(lat)
    if x_ecef.shape != mask_land.shape or x_ecef.shape[0] != lat.size:
        raise ValueError("Input data has inconsistent dimension length(s)")
    if mask_land.dtype != np.bool_:
        raise ValueError("'mask_land' must be a boolean mask")
    if ellps not in ("sphere", "GRS80", "WGS84"):
        raise ValueError("invalid value for 'ellps'")
    if block_size % 2 != 1:
        raise ValueError("Integer value for 'block_size' must be uneven")

    t_start = time.time()
    half = block_size // 2
    radius = _block_chord_radius(lat, dem_res, half, ellps)
    if radius > dist_thr:
        raise ValueError("Maximal chord distance is larger than 'dist_thr'")

    tree = KDTree(pts_ecef)
    nr, nc = x_ecef.shape
    # Block centres: one sample per block_size cells, starting at `half`.
    rows_c = np.arange(half, nr, block_size)
    cols_c = np.arange(half, nc, block_size)
    centres = np.column_stack(
        [a[np.ix_(rows_c, cols_c)].ravel() for a in arrays])
    d_centre = tree.query(centres, k=1, workers=-1)[0] \
        .reshape(rows_c.size, cols_c.size)

    # -1 = ambiguous, 0 = whole block within buffer, 1 = whole block out.
    verdict = np.full(d_centre.shape, -1, dtype=np.int8)
    verdict[d_centre <= dist_thr - radius] = 0
    verdict[d_centre > dist_thr + radius] = 1
    # Broadcast block verdicts to cells; cells beyond the last centred
    # block (truncated edge blocks) stay ambiguous.
    cell_verdict = np.full(x_ecef.shape, -1, dtype=np.int8)
    full_r = rows_c.size * block_size
    full_c = cols_c.size * block_size
    spread = np.kron(verdict, np.ones((block_size, block_size), np.int8))
    cell_verdict[:full_r, :full_c] = spread[:min(full_r, nr),
                                            :min(full_c, nc)]

    unresolved = cell_verdict == -1
    share = 100.0 * unresolved.sum() / unresolved.size
    print(f"Number of remaining grid cells: {unresolved.sum()} "
          f"(fraction: {share:.2f} %)")
    if unresolved.any():
        queries = np.column_stack([a[unresolved] for a in arrays])
        d_cell = tree.query(queries, k=1, workers=-1)[0]
        cell_verdict[unresolved] = (d_cell > dist_thr).astype(np.int8)

    cell_verdict[mask_land] = 0
    print("Run time: %.2f" % (time.time() - t_start) + " s")
    return cell_verdict.astype(bool)

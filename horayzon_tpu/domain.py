# Copyright (c) 2026
# MIT License
"""Domain sizing: expand the user domain by the horizon search distance.

Equivalent of reference ``horayzon/domain.py`` (planar_grid
domain.py:11, curved_grid :45).  The reference uses geographiclib's geodesic
``Direct`` solve for the latitude expansion; since the azimuth is always 0 or
180 degrees there, this reduces to a meridian arc, which is integrated here
directly (RK4 on the meridian radius of curvature) to sub-millimetre accuracy
without the geographiclib dependency.
"""

import numpy as np

from horayzon_tpu.transform import ellipsoid_params


def planar_grid(domain, dist_search=50.0):
    """Outer planar domain boundaries.

    Mirrors reference domain.py:11-40.

    Parameters
    ----------
    domain : dict
        Boundaries (x_min, x_max, y_min, y_max) [metre].
    dist_search : float
        Horizon search distance [kilometre].
    """
    if ((domain["x_min"] >= domain["x_max"])
            or (domain["y_min"] >= domain["y_max"])):
        raise ValueError("Invalid domain specification")
    d = dist_search * 1000.0
    return {"x_min": domain["x_min"] - d, "x_max": domain["x_max"] + d,
            "y_min": domain["y_min"] - d, "y_max": domain["y_max"] + d}


def _meridian_shift(lat, dist_m, ellps):
    """Latitude reached by travelling ``dist_m`` along the meridian.

    Positive ``dist_m`` moves north.  RK4 integration of
    dphi/ds = 1 / M(phi) with M the meridian radius of curvature."""
    a, _, e_2 = ellipsoid_params(ellps)

    def dphi_ds(phi):
        m = a * (1.0 - e_2) / (1.0 - e_2 * np.sin(phi) ** 2) ** 1.5
        return 1.0 / m

    phi = np.deg2rad(lat)
    n_steps = 64
    h = dist_m / n_steps
    for _ in range(n_steps):
        k1 = dphi_ds(phi)
        k2 = dphi_ds(phi + 0.5 * h * k1)
        k3 = dphi_ds(phi + 0.5 * h * k2)
        k4 = dphi_ds(phi + h * k3)
        phi = phi + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return float(np.rad2deg(phi))


def curved_grid(domain, dist_search=50.0, ellps="sphere"):
    """Outer curved (lon/lat) domain boundaries.

    Mirrors reference domain.py:45-113: the longitude expansion uses the
    parallel-circle radius at the largest absolute latitude; the latitude
    expansion follows the meridian by ``dist_search``.
    """
    if ellps not in ("sphere", "GRS80", "WGS84"):
        raise NotImplementedError("ellipsoid " + ellps + " is not supported")
    if ((domain["lon_min"] >= domain["lon_max"])
            or (domain["lat_min"] >= domain["lat_max"])):
        raise ValueError("Invalid domain specification")

    a, _, e_2 = ellipsoid_params(ellps)
    d = dist_search * 1000.0
    lat_abs_max = max(abs(domain["lat_min"]), abs(domain["lat_max"]))
    rad_sph = (a / np.sqrt(1.0 - e_2 * np.sin(np.deg2rad(lat_abs_max)) ** 2)
               * np.cos(np.deg2rad(lat_abs_max)))
    lon_add = 360.0 / (2.0 * np.pi * rad_sph) * d
    domain_outer = {
        "lon_min": domain["lon_min"] - lon_add,
        "lon_max": domain["lon_max"] + lon_add,
        "lat_min": _meridian_shift(domain["lat_min"], -d, ellps),
        "lat_max": _meridian_shift(domain["lat_max"], +d, ellps),
    }
    if ((domain_outer["lon_min"] < -180.0)
            or (domain_outer["lon_max"] > 180.0)
            or (domain_outer["lat_min"] < -90.0)
            or (domain_outer["lat_max"] > 90.0)):
        raise ValueError("total domain exceeds valid range")
    return domain_outer

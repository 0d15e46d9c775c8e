# Copyright (c) 2026
# MIT License
"""Pure-NumPy brute-force oracles for cross-implementation tests.

Plays the role Embree plays in the reference: an independent, simple,
trusted implementation of horizon / shadow queries against the bilinear
heightfield, evaluated densely (no mips, no shift tricks).
"""

import numpy as np


def bilinear(z, fi, fj):
    h, w = z.shape
    i0 = np.clip(np.floor(fi).astype(int), 0, h - 2)
    j0 = np.clip(np.floor(fj).astype(int), 0, w - 2)
    wi = fi - i0
    wj = fj - j0
    return ((1 - wi) * (1 - wj) * z[i0, j0]
            + (1 - wi) * wj * z[i0, j0 + 1]
            + wi * (1 - wj) * z[i0 + 1, j0]
            + wi * wj * z[i0 + 1, j0 + 1])


def brute_horizon(z, dx, dy, offset, inner_shape, azim, dist_search,
                  ray_org_elev=0.01, elev_low_deg=-15.0, elev_up_deg=89.98,
                  step_frac=0.5):
    """Dense ray-march horizon for every inner cell (planar geometry)."""
    off0, off1 = offset
    in0, in1 = inner_shape
    h, w = z.shape
    step = min(abs(dx), abs(dy)) * step_frac
    s = np.arange(step, dist_search + step / 2, step)
    hori = np.empty((in0, in1, len(azim)), dtype=np.float32)
    for k, a in enumerate(azim):
        ux, uy = np.sin(a), np.cos(a)
        di = s * uy / dy     # row shift in cells
        dj = s * ux / dx
        for i in range(in0):
            for j in range(in1):
                fi = i + off0 + di
                fj = j + off1 + dj
                valid = (fi >= 0) & (fi <= h - 1) & (fj >= 0) & (fj <= w - 1)
                z0 = z[i + off0, j + off1] + ray_org_elev
                if valid.any():
                    hs = bilinear(z, fi[valid], fj[valid])
                    tan_max = np.max((hs - z0) / s[valid])
                    ang = np.arctan(tan_max)
                else:
                    ang = -np.inf
                hori[i, j, k] = np.clip(ang, np.deg2rad(elev_low_deg),
                                        np.deg2rad(elev_up_deg))
    return hori


def brute_horizon_general(z, dx, dy, offset, inner_shape, azim, u_xy,
                          vec_norm, vec_north, dist_search,
                          ray_org_elev=0.01, elev_low_deg=-15.0,
                          elev_up_deg=89.98, step_frac=0.5):
    """Dense ray-march horizon in each cell's local tangent frame.

    The ray follows the horizontal marching direction ``u_xy[k]`` of
    azimuth ``k``; the elevation angle of terrain point ``w`` (relative to
    the lifted observer) is ``atan2(w . norm, w . u_cell)`` with
    ``u_cell = sin(a) * east + cos(a) * north`` and ``east = north x
    norm`` (reference horizon_comp.cpp:772-779)."""
    off0, off1 = offset
    in0, in1 = inner_shape
    h, w = z.shape
    step = min(abs(dx), abs(dy)) * step_frac
    s = np.arange(step, dist_search + step / 2, step)
    norm = np.asarray(vec_norm, np.float64)
    north = np.asarray(vec_north, np.float64)
    east = np.cross(north, norm)
    hori = np.empty((in0, in1, len(azim)), dtype=np.float32)
    for k, a in enumerate(azim):
        gx, gy = u_xy[k]
        fi_s = s * gy / dy
        fj_s = s * gx / dx
        for i in range(in0):
            for j in range(in1):
                n_c = norm[i, j]
                u_c = np.sin(a) * east[i, j] + np.cos(a) * north[i, j]
                z0 = z[i + off0, j + off1] + ray_org_elev * n_c[2]
                fi = i + off0 + fi_s
                fj = j + off1 + fj_s
                valid = (fi >= 0) & (fi <= h - 1) & (fj >= 0) & (fj <= w - 1)
                ang = -np.inf
                if valid.any():
                    dh = bilinear(z, fi[valid], fj[valid]) - z0
                    sv = s[valid]
                    num = sv * (gx * n_c[0] + gy * n_c[1]) + dh * n_c[2]
                    den = sv * (gx * u_c[0] + gy * u_c[1]) + dh * u_c[2]
                    ang = np.max(np.arctan2(num, den))
                hori[i, j, k] = np.clip(ang, np.deg2rad(elev_low_deg),
                                        np.deg2rad(elev_up_deg))
    return hori


def tilted_vectors(shape, tilt_deg, tilt_azim_deg=30.0):
    """Unit normal tilted by ``tilt_deg`` towards ``tilt_azim_deg``
    (clockwise from North) in every cell, with the north vector
    orthogonalised against it."""
    t = np.deg2rad(tilt_deg)
    b = np.deg2rad(tilt_azim_deg)
    norm = np.array([np.sin(t) * np.sin(b), np.sin(t) * np.cos(b),
                     np.cos(t)])
    north = np.array([0.0, 1.0, 0.0]) - norm[1] * norm
    north /= np.linalg.norm(north)
    vn = np.broadcast_to(norm, shape + (3,)).astype(np.float32)
    vno = np.broadcast_to(north, shape + (3,)).astype(np.float32)
    return np.ascontiguousarray(vn), np.ascontiguousarray(vno)


def brute_shadow(z, dx, dy, offset, inner_shape, sun_position,
                 ray_org_elev=0.05, step_frac=0.5):
    """Dense sun-ray occlusion test for every inner cell (planar).

    Returns boolean occlusion (terrain between cell and sun)."""
    off0, off1 = offset
    in0, in1 = inner_shape
    h, w = z.shape
    step = min(abs(dx), abs(dy)) * step_frac
    diag = np.hypot(h * abs(dy), w * abs(dx))
    s = np.arange(step, diag + step / 2, step)
    occ = np.zeros((in0, in1), dtype=bool)
    for i in range(in0):
        for j in range(in1):
            x0 = (j + off1) * dx
            y0 = (i + off0) * dy
            z0 = z[i + off0, j + off1] + ray_org_elev
            d = np.array([sun_position[0] - x0, sun_position[1] - y0,
                          sun_position[2] - z0])
            d = d / np.linalg.norm(d)
            dh = np.hypot(d[0], d[1])
            if dh < 1e-12:
                continue
            m = d[2] / dh
            fi = i + off0 + s * (d[1] / dh) / dy
            fj = j + off1 + s * (d[0] / dh) / dx
            valid = (fi >= 0) & (fi <= h - 1) & (fj >= 0) & (fj <= w - 1)
            if not valid.any():
                continue
            hs = bilinear(z, fi[valid], fj[valid])
            occ[i, j] = np.any(hs > z0 + s[valid] * m)
    return occ


def gaussian_bumps_terrain(h, w, seed=0, n_bumps=6, amp=400.0, dx=25.0):
    """Smooth random terrain: sum of Gaussian bumps."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    z = np.zeros((h, w), dtype=np.float64)
    for _ in range(n_bumps):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sig = rng.uniform(4.0, h / 4.0)
        a = rng.uniform(0.2, 1.0) * amp
        z += a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                          / (2 * sig ** 2)))
    return z.astype(np.float32)

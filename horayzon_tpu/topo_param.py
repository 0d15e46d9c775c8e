# Copyright (c) 2026
# MIT License
"""Derived terrain parameters (slope normals, SVF, VSF, openness).

Equivalent of reference ``horayzon/topo_param.pyx``
(slope_plane_meth topo_param.pyx:17, slope_vector_meth :230, sky_view_factor
:377, visible_sky_fraction :465, topographic_openness :548).

The reference iterates cell-by-cell in Cython and solves a 3x3 system per cell
with LAPACK ``sgesv`` (topo_param.pyx:179).  Here everything is batched jnp:
neighbourhood sums become shifted-slice reductions and the per-cell 3x3 solve
becomes a closed-form Cramer solve — fully vectorised and differentiable.
The per-cell 3x3 rotations run at full float32 precision (``_HIGHEST``): on
GPUs a default-precision float32 contraction may use TF32 tensor cores, which
keep only about three decimal digits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["slope_plane_meth", "slope_vector_meth", "sky_view_factor",
           "visible_sky_fraction", "topographic_openness",
           "surface_enlargement_factor", "slope_angle_aspect"]


def _as_f32(a, name):
    a = jnp.asarray(a)
    if a.dtype not in (jnp.float32, jnp.float64):
        raise ValueError(f"input array '{name}' has incorrect data type")
    return a.astype(jnp.float32)


def _nine_point_stack(a):
    """Stack the 3x3 neighbourhood of every interior cell: (9, H-2, W-2)."""
    h, w = a.shape
    return jnp.stack([a[k:k + h - 2, l:l + w - 2]
                      for k in range(3) for l in range(3)])


@functools.partial(jax.jit, static_argnames=("use_rot", "output_rot"))
def _slope_plane_core(x, y, z, rot_mat, use_rot, output_rot):
    # Translate: coordinates relative to the centre cell (topo_param.pyx:126-133)
    cx = x[1:-1, 1:-1]
    cy = y[1:-1, 1:-1]
    cz = z[1:-1, 1:-1]
    coord = jnp.stack([_nine_point_stack(x) - cx,
                       _nine_point_stack(y) - cy,
                       _nine_point_stack(z) - cz], axis=-1)  # (9, Hc, Wc, 3)
    if use_rot:
        rot = rot_mat[1:-1, 1:-1]  # (Hc, Wc, 3, 3)
        coord = jnp.einsum("hwab,khwb->khwa", rot, coord,
                           precision=_HIGHEST)

    xs, ys, zs = coord[..., 0], coord[..., 1], coord[..., 2]
    sx = jnp.sum(xs, axis=0)
    sy = jnp.sum(ys, axis=0)
    sz = jnp.sum(zs, axis=0)
    sxx = jnp.sum(xs * xs, axis=0)
    sxy = jnp.sum(xs * ys, axis=0)
    sxz = jnp.sum(xs * zs, axis=0)
    syy = jnp.sum(ys * ys, axis=0)
    syz = jnp.sum(ys * zs, axis=0)
    nine = jnp.full_like(sx, 9.0)

    # Solve  [[sxx sxy sx], [sxy syy sy], [sx sy 9]] v = [sxz, syz, sz]
    # per cell via Cramer's rule (replaces LAPACK sgesv, topo_param.pyx:179).
    a11, a12, a13 = sxx, sxy, sx
    a21, a22, a23 = sxy, syy, sy
    a31, a32, a33 = sx, sy, nine
    det = (a11 * (a22 * a33 - a23 * a32)
           - a12 * (a21 * a33 - a23 * a31)
           + a13 * (a21 * a32 - a22 * a31))
    v0 = (sxz * (a22 * a33 - a23 * a32)
          - a12 * (syz * a33 - a23 * sz)
          + a13 * (syz * a32 - a22 * sz)) / det
    v1 = (a11 * (syz * a33 - a23 * sz)
          - sxz * (a21 * a33 - a23 * a31)
          + a13 * (a21 * sz - syz * a31)) / det

    vec = jnp.stack([v0, v1, -jnp.ones_like(v0)], axis=-1)
    vec = vec / jnp.linalg.norm(vec, axis=-1, keepdims=True)
    # Orient upwards (topo_param.pyx:194-197)
    vec = jnp.where(vec[..., 2:3] < 0.0, -vec, vec)

    if use_rot and not output_rot:
        # Rotate back with the transposed matrices (topo_param.pyx:210-223)
        rot = rot_mat[1:-1, 1:-1]
        vec = jnp.einsum("hwba,hwb->hwa", rot, vec, precision=_HIGHEST)

    out = jnp.full(x.shape + (3,), jnp.nan, dtype=jnp.float32)
    return out.at[1:-1, 1:-1].set(vec)


def slope_plane_meth(x, y, z, rot_mat=None, output_rot=False):
    """Plane-based slope computation (ArcGIS 9-point least-squares fit).

    Mirrors reference topo_param.pyx:17-225.  Returns tilted surface normal
    unit vectors; border cells are NaN.

    Parameters
    ----------
    x, y, z : ndarray of float, shape (H, W)
        Grid coordinates [metre].
    rot_mat : ndarray of float, shape (H, W, 3, 3), optional
        Per-cell rotation matrices to a local frame whose z-axis is local up.
    output_rot : bool
        If True, return normals in the rotated (local) frame.

    Returns
    -------
    vec_tilt : ndarray of float32, shape (H, W, 3)
    """
    x = _as_f32(x, "x")
    y = _as_f32(y, "y")
    z = _as_f32(z, "z")
    if x.shape != y.shape or y.shape != z.shape:
        raise ValueError("Inconsistent shapes of input arrays")
    use_rot = rot_mat is not None
    if use_rot:
        rot_mat = _as_f32(rot_mat, "rot_mat")
        if rot_mat.shape[:2] != x.shape:
            raise ValueError("Inconsistent shapes of input arrays")
    else:
        rot_mat = jnp.zeros((1, 1, 3, 3), dtype=jnp.float32)
    return np.asarray(_slope_plane_core(x, y, z, rot_mat, use_rot, output_rot))


@functools.partial(jax.jit, static_argnames=("use_rot", "output_rot"))
def _slope_vector_core(x, y, z, rot_mat, use_rot, output_rot):
    c = jnp.stack([x[1:-1, 1:-1], y[1:-1, 1:-1], z[1:-1, 1:-1]], axis=-1)
    left = jnp.stack([x[1:-1, :-2], y[1:-1, :-2], z[1:-1, :-2]], axis=-1) - c
    down = jnp.stack([x[2:, 1:-1], y[2:, 1:-1], z[2:, 1:-1]], axis=-1) - c
    right = jnp.stack([x[1:-1, 2:], y[1:-1, 2:], z[1:-1, 2:]], axis=-1) - c
    up = jnp.stack([x[:-2, 1:-1], y[:-2, 1:-1], z[:-2, 1:-1]], axis=-1) - c
    vec = (jnp.cross(left, down) + jnp.cross(down, right)
           + jnp.cross(right, up) + jnp.cross(up, left)) / 4.0
    vec = vec / jnp.linalg.norm(vec, axis=-1, keepdims=True)
    vec = jnp.where(vec[..., 2:3] < 0.0, -vec, vec)
    if use_rot and output_rot:
        rot = rot_mat[1:-1, 1:-1]
        vec = jnp.einsum("hwab,hwb->hwa", rot, vec, precision=_HIGHEST)
    out = jnp.full(x.shape + (3,), jnp.nan, dtype=jnp.float32)
    return out.at[1:-1, 1:-1].set(vec)


def slope_vector_meth(x, y, z, rot_mat=None, output_rot=False):
    """Vector-based slope computation (average of 4 triangle normals).

    Mirrors reference topo_param.pyx:230-372 (Corripio 2003).
    """
    x = _as_f32(x, "x")
    y = _as_f32(y, "y")
    z = _as_f32(z, "z")
    if x.shape != y.shape or y.shape != z.shape:
        raise ValueError("Inconsistent shapes of input arrays")
    if output_rot and (rot_mat is None):
        raise ValueError("'rot_mat' must be provided for 'output_rot = True'")
    use_rot = rot_mat is not None
    if use_rot:
        rot_mat = _as_f32(rot_mat, "rot_mat")
        if rot_mat.shape[:2] != x.shape:
            raise ValueError("Inconsistent shapes of input arrays")
    else:
        rot_mat = jnp.zeros((1, 1, 3, 3), dtype=jnp.float32)
    return np.asarray(_slope_vector_core(x, y, z, rot_mat, use_rot,
                                         output_rot))


def svf_core_fn(azim, hori, vec_tilt):
    """Unjitted SVF core (for embedding in larger jitted programs)."""
    azim_sin = jnp.sin(azim)  # (A,)
    azim_cos = jnp.cos(azim)
    tx = vec_tilt[..., 0:1]
    ty = vec_tilt[..., 1:2]
    tz = vec_tilt[..., 2:3]
    # Plane-sphere intersection clamp (topo_param.pyx:442-449)
    hori_plane = jnp.arctan(-azim_sin * tx / tz - azim_cos * ty / tz)
    theta = jnp.maximum(hori, hori_plane)
    term = ((tx * azim_sin + ty * azim_cos)
            * ((jnp.pi / 2.0) - theta - jnp.sin(2.0 * theta) / 2.0)
            + tz * jnp.cos(theta) ** 2)
    azim_spac = azim[1] - azim[0]
    return (azim_spac / (2.0 * jnp.pi)) * jnp.sum(term, axis=-1)


#: Jitted entry for :func:`svf_core_fn`.
_svf_core = jax.jit(svf_core_fn)


def sky_view_factor(azim, hori, vec_tilt):
    """Sky view factor: fraction of isotropic sky radiation received.

    Mirrors reference topo_param.pyx:377-460.

    Parameters
    ----------
    azim : ndarray of float, shape (A,)
        Azimuth angles [radian].
    hori : ndarray of float, shape (H, W, A)
        Horizon elevation angles [radian].
    vec_tilt : ndarray of float, shape (H, W, 3)
        Tilted surface normal unit vectors.
    """
    azim = _as_f32(azim, "azim")
    hori = _as_f32(hori, "hori")
    vec_tilt = _as_f32(vec_tilt, "vec_tilt")
    if ((azim.shape[0] != hori.shape[2])
            or (hori.shape[:2] != vec_tilt.shape[:2])
            or (vec_tilt.shape[2] != 3)):
        raise ValueError("Inconsistent/incorrect shapes of input arrays")
    return np.asarray(_svf_core(azim, hori, vec_tilt))


@jax.jit
def _vsf_core(azim, hori, vec_tilt):
    azim_sin = jnp.sin(azim)
    azim_cos = jnp.cos(azim)
    tx = vec_tilt[..., 0:1]
    ty = vec_tilt[..., 1:2]
    tz = vec_tilt[..., 2:3]
    hori_plane = jnp.arctan(-azim_sin * tx / tz - azim_cos * ty / tz)
    theta = jnp.maximum(hori, hori_plane)
    term = 1.0 - jnp.cos((jnp.pi / 2.0) - theta)
    azim_spac = azim[1] - azim[0]
    return (azim_spac / (2.0 * jnp.pi)) * jnp.sum(term, axis=-1)


def visible_sky_fraction(azim, hori, vec_tilt):
    """Visible sky fraction: solid angle of the visible sky.

    Mirrors reference topo_param.pyx:465-543.
    """
    azim = _as_f32(azim, "azim")
    hori = _as_f32(hori, "hori")
    vec_tilt = _as_f32(vec_tilt, "vec_tilt")
    if ((azim.shape[0] != hori.shape[2])
            or (hori.shape[:2] != vec_tilt.shape[:2])
            or (vec_tilt.shape[2] != 3)):
        raise ValueError("Inconsistent/incorrect shapes of input arrays")
    return np.asarray(_vsf_core(azim, hori, vec_tilt))


@jax.jit
def _topo_core(hori):
    return jnp.mean((jnp.pi / 2.0) - hori, axis=-1)


def topographic_openness(azim, hori):
    """Positive topographic openness (Yokoyama et al. 2002).

    Mirrors reference topo_param.pyx:548-603.
    """
    azim = _as_f32(azim, "azim")
    hori = _as_f32(hori, "hori")
    if azim.shape[0] != hori.shape[2]:
        raise ValueError("Inconsistent/incorrect shapes of input arrays")
    return np.asarray(_topo_core(hori))


def surface_enlargement_factor(vec_norm, vec_tilt):
    """Surface enlargement factor 1 / (norm . tilt).

    Helper replicating the computation in the reference examples
    (e.g. examples/shadow/gridded_planar_DEM_artificial.py:96-99).
    """
    vec_norm = np.asarray(vec_norm, dtype=np.float32)
    vec_tilt = np.asarray(vec_tilt, dtype=np.float32)
    return (1.0 / (vec_norm * vec_tilt).sum(axis=-1)).astype(np.float32)


def slope_angle_aspect(vec_tilt):
    """Slope angle and aspect (clockwise from North) from tilted normals.

    Helper replicating e.g. examples/horizon/gridded_planar_DEM.py:113-116.
    Returns (slope [radian], aspect [radian, 0..2pi]).
    """
    vec_tilt = np.asarray(vec_tilt, dtype=np.float32)
    slope = np.arccos(np.clip(vec_tilt[..., 2], a_min=None, a_max=1.0))
    aspect = np.pi / 2.0 - np.arctan2(vec_tilt[..., 1], vec_tilt[..., 0])
    aspect = np.where(aspect < 0.0, aspect + 2.0 * np.pi, aspect)
    return slope.astype(np.float32), aspect.astype(np.float32)

"""GPU tier: the XLA engine on the card against the native CPU oracles.

Marked ``gpu``: each test skips unless JAX's first device is a GPU (the
``gpu_device`` fixture).  ``python chip_smoke.py`` runs this file on the
card in its own process.
"""

import numpy as np
import pytest

from reference_impl import gaussian_bumps_terrain

pytestmark = pytest.mark.gpu


def test_sweep_matches_native_oracle_on_gpu(gpu_device):
    """A 512^2 sweep with a 5 km search (dense and max-mip phases) agrees
    with the native ray-marcher within hori_acc on a 32^2 window."""
    from horayzon_tpu.native import fastdem
    from horayzon_tpu.ops import sweep

    dx, dist, halo, inner = 25.0, 5000.0, 208, 512
    n = inner + 2 * halo
    z = gaussian_bumps_terrain(n, n, seed=2, amp=900.0, n_bumps=40)
    azim = (2 * np.pi / 64) * np.arange(64)
    hori, _ = sweep.horizon_sweep(
        z, dx=dx, dy=-dx, offset=(halo, halo), inner_shape=(inner, inner),
        azim=azim, dist_search=dist, hori_acc=0.25)
    assert list(hori.devices())[0].platform == "gpu"
    r0 = c0 = 240
    ref, _ = fastdem.horizon_march(z, dx, -dx, (halo + r0, halo + c0),
                                   (32, 32), azim, dist, step=dx / 2)
    d = np.rad2deg(np.abs(np.asarray(hori)[r0:r0 + 32, c0:c0 + 32] - ref))
    assert d.max() <= 0.25, f"max {d.max():.4f} deg"


def test_shadow_matches_native_oracle_on_gpu(gpu_device):
    """Terrain occlusion on the card agrees with the native sun-ray
    march on at least 98 % of the non-self-shaded cells."""
    from horayzon_tpu import auxiliary, shadow
    from horayzon_tpu.native import fastdem

    dx, n, off, inner = 25.0, 384, 64, 256
    z = gaussian_bumps_terrain(n, n, seed=3, amp=700.0, n_bumps=30)
    xs = np.arange(n, dtype=np.float32) * dx
    ys = -np.arange(n, dtype=np.float32) * dx
    xx, yy = np.meshgrid(xs, ys)
    vec = np.zeros((inner, inner, 3), np.float32)
    vec[..., 2] = 1.0
    t = shadow.Terrain()
    t.initialise(auxiliary.rearrange_pad_buffer(xx, yy, z), n, n, off, off,
                 vec, vec, np.ones((inner, inner), np.float32),
                 z[off:off + inner, off:off + inner],
                 np.ones((inner, inner), np.uint8))
    sun = np.array([-6.0e8, 4.0e8, 1.2e8])
    codes = t.shadow(sun.astype(np.float32))
    occ = fastdem.shadow_march(z, dx, -dx, (off, off), (inner, inner), sun,
                               step=dx / 2).astype(bool)
    lit = codes != 1
    agree = ((codes == 2) == occ)[lit].mean()
    assert 0.02 < (codes == 2).mean() < 0.98
    assert agree >= 0.98, f"agreement {agree:.4f}"


@pytest.mark.parametrize("method", ["plane_local", "plane_global",
                                    "vector_local"])
def test_rotated_normals_full_precision_on_gpu(gpu_device, method):
    """The rotated slope normals keep float32 accuracy on the card, where
    a default-precision float32 contraction may run in TF32."""
    from test_topo_param import test_rotated_normals_match_float64

    test_rotated_normals_match_float64(method)

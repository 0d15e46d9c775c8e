# Tests run on a virtual 8-device CPU mesh so sharded paths are exercised
# without accelerator hardware (SURVEY.md section 4: multi-host without a
# cluster).
#
# Note: JAX may already be imported when this file runs, so the platform is
# also forced with jax.config.update after import.  XLA_FLAGS is read lazily
# at first backend initialisation, so setting it here works.
#
# GPU tier: HORAYZON_GPU_TESTS=1 keeps the process's own backend (the card)
# so the `gpu`-marked tests can run there; `python chip_smoke.py` runs them
# in its own process.  Each such test decides inside its `gpu_device`
# fixture whether a card is present and skips otherwise.
import os
import sys

import pytest

if os.environ.get("HORAYZON_GPU_TESTS") != "1":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform is {dev.platform}; "
                    f"run `python chip_smoke.py` on the card)")
    return dev


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

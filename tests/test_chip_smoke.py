"""chip_smoke.py: refuses to run without a GPU, keeps its compile cache
where it should, and its phases run end to end at tiny sizes on the CPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    """With JAX held to the CPU, and in a directory holding nothing of the
    repository but the script, it exits non-zero and prints no result."""
    script = SMOKE
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
    out = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, monkeypatch, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the entry
    scripts' default (the repository's .jax_cache) is used."""
    from horayzon_tpu.utils import profiling

    default = str(tmp_path / "repo" / ".jax_cache")
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        used = profiling.use_compile_cache(default)
        expect = str(tmp_path / "c") if env_set else default
        assert used == expect
        assert jax.config.jax_compilation_cache_dir == expect
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("phases", ["planar_and_track", "hemisphere",
                                    "gradient"])
def test_chip_smoke_phases_tiny(phases):
    """The smoke's phases and checks, at tiny sizes on the CPU."""
    sys.path.insert(0, REPO)
    import chip_smoke

    if phases == "planar_and_track":
        x, y, z, pipe, out = chip_smoke.phase_planar(
            inner=(48, 64), dist_km=2.0, azim_num=16, window=16)
        assert out["hori"].shape == (48, 64, 16)
        chip_smoke.phase_shadow_track(x, y, z, pipe, out, window=16)
    elif phases == "hemisphere":
        chip_smoke.phase_shadow_hemisphere(dx=400.0, azim_steps=9)
    else:
        chip_smoke.phase_gradient(steps=10)


@pytest.mark.parametrize("wrong, match", [
    (lambda g: -g, "central difference"),
    (lambda g: 0.5 * g, "central difference"),
    (lambda g: 0.0 * g, "not finite and nonzero")])
def test_chip_smoke_gradient_check_rejects_wrong_gradient(monkeypatch, wrong,
                                                          match):
    """The gradient phase fails on a gradient of the wrong sign, of half
    the size, or of zero."""
    sys.path.insert(0, REPO)
    import chip_smoke

    grad = jax.value_and_grad

    def broken(fn, **kw):
        vg = grad(fn, **kw)

        def wrapped(z):
            val, g = vg(z)
            return val, wrong(g)
        return wrapped

    monkeypatch.setattr(jax, "value_and_grad", broken)
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.phase_gradient(steps=1)

# Description: Recover a hidden terrain feature from horizon observations
#              by gradient descent through the horizon sweep —
#              the capability the reference cannot express (its Embree
#              core is not differentiable; SURVEY.md section 7 step 8
#              calls differentiability "the genuinely new capability").
#
#              A "true" DEM contains a ridge the initial DEM is missing.
#              Per-cell, per-azimuth horizon angles observed on the true
#              terrain are the measurements; Adam on the elevation field
#              minimises the squared horizon mismatch, with gradients
#              from jax.grad through the shifted-slice sweep
#              (ops/sweep.py).  A small Laplacian regulariser keeps the
#              solution smooth where horizons carry no information.
#
# Runs on any JAX backend; --plot saves the true / initial / recovered
# elevation maps and the loss curve.
#
# Copyright (c) 2026
# MIT License

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..")))  # run without install

import numpy as np


def terrains(n, dx, seed=0):
    """(true, initial) DEM pair: smooth rolling base + a ridge only the
    true terrain has."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) * dx
    base = np.zeros((n, n))
    for _ in range(10):
        cx, cy = rng.uniform(0, n * dx, 2)
        sig = rng.uniform(n / 10, n / 4) * dx
        base += rng.uniform(80, 300) * np.exp(
            -(((x - cx) ** 2 + (y - cy) ** 2) / (2 * sig ** 2)))
    ridge = 220.0 * np.exp(-((y - 0.34 * n * dx) ** 2)
                           / (2 * (3.5 * dx) ** 2))
    ridge *= np.exp(-((x - 0.55 * n * dx) ** 2)
                    / (2 * (0.18 * n * dx) ** 2))
    return ((base + ridge).astype(np.float32), base.astype(np.float32))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=192,
                    help="outer DEM cells per side")
    ap.add_argument("--inner", type=int, default=64)
    ap.add_argument("--dx", type=float, default=25.0)
    ap.add_argument("--dist-search", type=float, default=1.5,
                    help="horizon search distance [km]")
    ap.add_argument("--azim-num", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=2.0)
    ap.add_argument("--smooth", type=float, default=0.02,
                    help="Laplacian regulariser weight")
    ap.add_argument("--out", default="/tmp/horayzon_tpu_out")
    ap.add_argument("--plot", action="store_true")
    return ap


def build_problem(args):
    """Observations on the true terrain and the fit's loss.

    Returns ``(z_true, z_init, loss_fn)``: numpy DEMs and a function of the
    elevation field returning ``(loss, horizon MSE)``."""
    import jax.numpy as jnp

    from horayzon_tpu.ops import sweep

    n, inner = args.n, args.inner
    halo = (n - inner) // 2
    z_true, z_init = terrains(n, args.dx, seed=3)
    azim = (2 * np.pi / args.azim_num) * np.arange(args.azim_num)

    def hori_of(z):
        hori, _ = sweep.horizon_sweep(
            z, dx=args.dx, dy=-args.dx, offset=(halo, halo),
            inner_shape=(inner, inner), azim=azim,
            dist_search=args.dist_search * 1000.0, hori_acc=0.25)
        return hori

    hori_obs = hori_of(jnp.asarray(z_true))

    def loss_fn(z):
        data = jnp.mean((hori_of(z) - hori_obs) ** 2)
        lap = (z[1:-1, 1:-1] * 4 - z[:-2, 1:-1] - z[2:, 1:-1]
               - z[1:-1, :-2] - z[1:-1, 2:]) / args.dx
        return data + args.smooth * jnp.mean(lap ** 2), data

    return z_true, z_init, loss_fn


def fit(loss_fn, z_init, z_true, steps, lr):
    """Adam on the elevation field (plain jnp: no optimiser dependency).

    Returns the fitted field and the horizon MSE before each step."""
    import jax
    import jax.numpy as jnp

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    z = jnp.asarray(z_init)
    m = jnp.zeros_like(z)
    v = jnp.zeros_like(z)
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for it in range(steps):
        (loss, data), g = vg(z)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (it + 1))
        vh = v / (1 - b2 ** (it + 1))
        z = z - lr * mh / (jnp.sqrt(vh) + eps)
        losses.append(float(data))
        if it % 25 == 0 or it == steps - 1:
            err = float(jnp.abs(z - z_true).max())
            print(f"step {it:4d}: horizon MSE {float(data):.3e} rad^2, "
                  f"max |z - z_true| = {err:.1f} m")
    return z, losses


def main():
    args = build_parser().parse_args()
    n, inner = args.n, args.inner
    halo = (n - inner) // 2
    z_true_np, z_init_np, loss_fn = build_problem(args)
    print(f"observations: {inner}x{inner} cells x {args.azim_num} "
          f"azimuths")
    t0 = time.time()
    z, losses = fit(loss_fn, z_init_np, z_true_np, args.steps, args.lr)
    print(f"{args.steps} steps in {time.time() - t0:.1f} s")

    # The ridge must be materially recovered where horizons constrain
    # it.  Horizon angles are invariant under a uniform elevation shift
    # (terrain and observers rise together), so elevation is recoverable
    # only up to that gauge: score the error after removing the optimal
    # global shift.
    sl = (slice(halo - 8, halo + inner + 8), slice(halo, halo + inner))

    def gauge_err(zz):
        d = (np.asarray(zz) - z_true_np)[sl]
        return np.abs(d - np.median(d))

    e0 = gauge_err(z_init_np)
    e1 = gauge_err(z)
    print(f"shift-adjusted elevation error over the constrained region: "
          f"{e0.mean():.2f} m -> {e1.mean():.2f} m "
          f"(max {e0.max():.1f} -> {e1.max():.1f})")
    if args.steps >= 100:     # smoke runs with few steps skip the check
        assert e1.max() < 0.5 * e0.max(), \
            "gradient fit failed to recover the ridge"
        assert losses[-1] < 0.05 * losses[0], "horizon misfit not reduced"
        print("RECOVERY OK")

    os.makedirs(args.out, exist_ok=True)
    np.savez_compressed(
        os.path.join(args.out, "terrain_fit_gradient.npz"),
        z_true=z_true_np, z_init=z_init_np, z_fit=np.asarray(z),
        losses=np.asarray(losses))
    print("saved:", os.path.join(args.out, "terrain_fit_gradient.npz"))
    if args.plot:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        import plots_util
        frames = np.stack([z_true_np[sl], z_init_np[sl],
                           np.asarray(z)[sl], e1])
        plots_util.plot_frames(
            args.out, frames,
            titles=["true elevation [m]", "initial (no ridge)",
                    "recovered by jax.grad", "abs error after fit [m]"],
            name="terrain_fit_gradient.png", cmap="viridis",
            vmin=None)
        plots_util.plot_series(
            args.out, np.arange(len(losses)), np.asarray(losses),
            xlabel="Adam step", ylabel="horizon MSE [rad^2]",
            name="terrain_fit_loss.png")


if __name__ == "__main__":
    main()

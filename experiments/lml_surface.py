"""Negative-LML surfaces: the ridge / non-identifiability study.

Rebuild of the reference study (experiments/lml_surface.py:93-221): contour
surfaces of the negative log marginal likelihood over (lengthscale, noise)
for growing train sizes, plus an ML-II convergence scatter from random
initialisations — the motivation for being Bayesian about hyperparameters.
Here the whole (grid x train-size) surface is one vmapped-jitted
evaluation instead of nested Python loops.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ggp_tpu.kernels import default_rbf
from ggp_tpu.models.gpr_hmc import gp_marginal_loglik
from ggp_tpu.utils.load_data import DataConfig, KernelConfig, load_1d_synthetic


def nll_surface(X, y, ls_grid, noise_grid, outputscale=1.0):
    kern = default_rbf(ard=False)

    def nll(log_ls, log_noise):
        p = {"kernel": {"log_outputscale": jnp.log(jnp.asarray(outputscale)),
                        "base": {"log_lengthscale": log_ls}},
             "log_noise": log_noise}
        return -gp_marginal_loglik(kern, p, X, y, 1e-8)

    f = jax.vmap(jax.vmap(nll, in_axes=(None, 0)), in_axes=(0, None))
    return jax.jit(f)(jnp.log(ls_grid), jnp.log(noise_grid))


def mlii_converged_points(X, y, n_inits=100, steps=400, key=None):
    """ML-II from random inits -> scatter of converged (ls, noise)
    (reference: lml_surface.py:150-221)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    kern = default_rbf(ard=False)
    optimizer = optax.adam(0.05)

    def run_one(k):
        k1, k2 = jax.random.split(k)
        p = {"kernel": {"log_outputscale": jnp.zeros(()),
                        "base": {"log_lengthscale":
                                 jax.random.uniform(k1, (), minval=-2.3,
                                                    maxval=2.3)}},
             "log_noise": jax.random.uniform(k2, (), minval=-7.0, maxval=1.0)}
        s = optimizer.init(p)

        def step(carry, _):
            p, s = carry
            g = jax.grad(lambda q: -gp_marginal_loglik(kern, q, X, y, 1e-8))(p)
            u, s = optimizer.update(g, s, p)
            return (optax.apply_updates(p, u), s), None

        (p, _), _ = jax.lax.scan(step, (p, s), None, length=steps)
        return (jnp.exp(p["kernel"]["base"]["log_lengthscale"]),
                jnp.exp(p["log_noise"]))

    keys = jax.random.split(key, n_inits)
    return jax.jit(jax.vmap(run_one))(keys)


def main(plot=True):
    ls_grid = jnp.asarray(np.logspace(-1, 1.2, 60), jnp.float32)
    noise_grid = jnp.asarray(np.logspace(-4, 0.5, 60), jnp.float32)
    sizes = [10, 20, 40, 80]
    X_all, y_all, _ = load_1d_synthetic(
        data_cfg=DataConfig(n=max(sizes), noise=0.3),
        kernel_cfg=KernelConfig(lengthscale=1.0, outputscale=1.0), seed=23)

    surfaces = []
    for n in sizes:
        S = nll_surface(X_all[:n], y_all[:n], ls_grid, noise_grid)
        surfaces.append(np.asarray(S))
        print(f"n={n}: min NLL {np.nanmin(S):.2f} ({np.isnan(S).mean()*100:.0f}% cells failed chol)")

    ls_c, noise_c = mlii_converged_points(X_all[:20], y_all[:20])
    ls_c, noise_c = np.asarray(ls_c), np.asarray(noise_c)
    n_modes = len(np.unique(np.round(np.log10(noise_c), 1)))
    print(f"ML-II from 100 inits on n=20: noise spans "
          f"[{noise_c.min():.2e}, {noise_c.max():.2e}] (~{n_modes} clusters) "
          f"- the ridge pathology")

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import os
        fig, axes = plt.subplots(1, len(sizes), figsize=(4 * len(sizes), 3.5))
        for ax, S, n in zip(axes, surfaces, sizes):
            c = ax.contourf(np.asarray(ls_grid), np.asarray(noise_grid),
                            S.T - S.min(), levels=30)
            ax.set_xscale("log"); ax.set_yscale("log")
            ax.set_title(f"n={n}")
            ax.set_xlabel("lengthscale")
            if n == sizes[0]:
                ax.set_ylabel("noise var")
            fig.colorbar(c, ax=ax)
        axes[1].plot(ls_c, noise_c, "r.", ms=3)
        os.makedirs("results", exist_ok=True)
        fig.savefig("results/lml_surface.png", dpi=120, bbox_inches="tight")
        print("saved results/lml_surface.png")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--no_plot", action="store_true")
    a = p.parse_args()
    main(plot=not a.no_plot)

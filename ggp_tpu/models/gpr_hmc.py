"""GPR_HMC — exact (dense) GP with NUTS over hyperparameters.

Rebuild of the reference's ``GPR_HMC`` (models/gpr_hmc.py:23-119): pymc3
``pm.gp.Marginal`` with ls ~ Gamma(2,1), sig_f ~ HalfCauchy(1),
sig_n ~ HalfCauchy(1) (models/gpr_hmc.py:47-53), NUTS single chain
(models/gpr_hmc.py:57), mixture predictive over the trace with a noise-floor
clamp sig_n^2 < 1e-4 -> 0.01 (models/gpr_hmc.py:99-100).

Differences by design: the marginal-likelihood target and its gradient are
one jitted function (one N x N Cholesky); chains are vmapped; the whole
mixture predictive is one vmap over trace samples instead of a Python loop
with try/except PSD filtering (models/gpr_hmc.py:113-117) — non-finite
components are masked instead.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import default_jitter
from ..inference.hmc import NUTSConfig, build_sampler
from ..kernels import Kernel, default_rbf
from ..likelihoods import GaussianLikelihood
from ..ops.linalg import mvn_logpdf_chol, safe_cholesky, tri_solve
from ..priors import log_prior, prior_tree_rbf

__all__ = ["GPR_HMC", "gp_marginal_loglik", "gp_predict"]


def gp_marginal_loglik(kernel: Kernel, params: dict, X: jnp.ndarray,
                       y: jnp.ndarray, jitter: Optional[float] = None):
    """Dense log marginal likelihood log N(y | 0, K + sig_n^2 I)."""
    s2 = jnp.exp(params["log_noise"])
    K = kernel.gram(params["kernel"], X, X) + s2 * jnp.eye(X.shape[0], dtype=X.dtype)
    L = safe_cholesky(K, jitter)
    return mvn_logpdf_chol(y, jnp.zeros_like(y), L)


def gp_predict(kernel: Kernel, params: dict, X: jnp.ndarray, y: jnp.ndarray,
               X_test: jnp.ndarray, jitter: Optional[float] = None,
               include_noise: bool = True):
    """Exact GP predictive marginals."""
    s2 = jnp.exp(params["log_noise"])
    K = kernel.gram(params["kernel"], X, X) + s2 * jnp.eye(X.shape[0], dtype=X.dtype)
    L = safe_cholesky(K, jitter)
    Ks = kernel.gram(params["kernel"], X, X_test)
    alpha = tri_solve(L, y)
    v = tri_solve(L, Ks)
    mean = v.T @ alpha
    var = kernel.diag(params["kernel"], X_test) - jnp.sum(v * v, axis=0)
    var = jnp.maximum(var, 1e-12)
    if include_noise:
        var = var + s2
    return mean, var


class GPR_HMC:
    """Reference API: ctor (train_x, train_y, likelihood), ``train_model``
    (models/gpr_hmc.py:61-78), ``full_mixture_posterior_predictive``
    (models/gpr_hmc.py:93-119)."""

    def __init__(self, train_x, train_y, likelihood: GaussianLikelihood | None = None,
                 kernel: Kernel | None = None, prior_tree=None,
                 jitter: float | None = None, mesh=None):
        self.train_x = jnp.asarray(train_x)
        self.train_y = jnp.asarray(train_y)
        d = self.train_x.shape[-1]
        self.kernel = kernel if kernel is not None else default_rbf(ard=True)
        self.likelihood = likelihood if likelihood is not None else GaussianLikelihood()
        self.jitter = default_jitter(self.train_x.dtype) if jitter is None else jitter
        self.prior_tree = prior_tree if prior_tree is not None else prior_tree_rbf()
        self.params = {
            "kernel": self.kernel.init_params(d),
            "log_noise": jnp.zeros((), self.train_x.dtype),
        }
        self.mesh = mesh
        self.trace = None
        self._sampler = None
        self._sampler_cfg = None

    def _logpost(self, hypers, data):
        X, y = data
        ll = gp_marginal_loglik(self.kernel, hypers, X, y, self.jitter)
        return ll + log_prior(self.prior_tree, hypers)

    def train_model(self, num_warmup: int = 50, num_samples: int = 10,
                    num_chains: int = 1, key=None, max_depth: int = 8):
        """NUTS over (log ls, log sig_f^2, log sig_n^2). Reference defaults
        tune=50, n=10 (models/gpr_hmc.py:61-78); crank these up for quality —
        they're cheap here."""
        if key is None:
            key = jax.random.PRNGKey(0)
        cfg = NUTSConfig(num_warmup=num_warmup, num_samples=num_samples,
                         max_depth=max_depth)
        if self._sampler is None or self._sampler_cfg != (cfg, num_chains):
            self._sampler = build_sampler(
                self._logpost, self.params, cfg, num_chains, mesh=self.mesh)
            self._sampler_cfg = (cfg, num_chains)
        samples, stats = self._sampler(self.params, key,
                                       (self.train_x, self.train_y))
        # flatten chains into the trace (reference stores a single chain)
        self.trace = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:]), samples)
        self.stats = stats
        return self.trace

    def full_mixture_posterior_predictive(self, test_x, noise_floor: bool = True):
        """Per-sample exact-GP predictives, vmapped over the trace.

        Returns (means, vars) with leading axis = number of trace samples.
        The reference clamps tiny sampled noise to 0.01
        (models/gpr_hmc.py:99-100); we reproduce that under ``noise_floor``.
        """
        test_x = jnp.asarray(test_x)

        def one(hypers):
            if noise_floor:
                s2 = jnp.exp(hypers["log_noise"])
                s2 = jnp.where(s2 < 1e-4, 0.01, s2)
                hypers = {**hypers, "log_noise": jnp.log(s2)}
            return gp_predict(self.kernel, hypers, self.train_x, self.train_y,
                              test_x, self.jitter)

        means, vars_ = jax.jit(
            lambda tr: jax.lax.map(one, tr, batch_size=8))(self.trace)
        ok = jnp.all(jnp.isfinite(means), axis=-1) & \
             jnp.all(jnp.isfinite(vars_), axis=-1)
        return means[ok], vars_[ok]

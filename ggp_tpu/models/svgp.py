"""SVGP — Hensman (2013/15) uncollapsed variational sparse GP with SVI.

Rebuild of ``StochasticVariationalGP`` (models/svgp.py:24-141): whitened
q(u) = N(m, L L^T) with free Cholesky (gpytorch CholeskyVariationalDistribution,
models/svgp.py:37), learnable inducing locations (models/svgp.py:43,46),
minibatch ELBO with num_data scaling (VariationalELBO(num_data=N),
models/svgp.py:90), non-Gaussian likelihoods (the reference routes
classification through a multitask wrapper chosen by probing
``likelihood.noise``, models/svgp.py:40-46 — here the likelihood object
declares its latent count directly).

Design: the entire multi-epoch minibatch loop is a nested ``lax.scan`` under
one jit (epoch-level permutation + step-level dynamic slicing), instead of a
Python epoch loop over a host DataLoader (models/svgp.py:93-127). C latent
functions are handled by batched (C-leading) cholesky/solves — one batched
factorisation, not a loop.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from ..config import default_jitter
from ..kernels import Kernel, default_rbf
from ..likelihoods import GaussianLikelihood, Likelihood, Softmax
from ..ops.linalg import safe_cholesky, tri_solve

__all__ = ["StochasticVariationalGP", "svgp_elbo", "svgp_predict_f"]


def _build_L(q_sqrt_raw: jnp.ndarray) -> jnp.ndarray:
    """(..., M, M) raw -> lower-tri with exp diag (positive-definite chol)."""
    L = jnp.tril(q_sqrt_raw, k=-1)
    diag = jnp.exp(jnp.diagonal(q_sqrt_raw, axis1=-2, axis2=-1))
    return L + jnp.vectorize(jnp.diag, signature="(m)->(m,m)")(diag)


def _whitened_q_f(kernel, kp, Z, q_mu, q_L, X, jitter, full_cov=False):
    """q(f(X)) moments under whitened u = Lk v, q(v)=N(q_mu, q_L q_L^T).

    q_mu: (M, C); q_L: (C, M, M). Returns mean (Nb, C), var (Nb, C).
    """
    Kmm = kernel.gram(kp, Z, Z)
    Lk = safe_cholesky(Kmm, jitter, relative=True)
    Kms = kernel.gram(kp, Z, X)
    A = tri_solve(Lk, Kms)                         # (M, Nb)
    mean = A.T @ q_mu                              # (Nb, C)
    SA = jnp.einsum("cmk,kn->cmn", jnp.swapaxes(q_L, -1, -2), A)  # L^T A
    if full_cov:
        Kss = kernel.gram(kp, X, X)
        cov = Kss[None] - (A.T @ A)[None] + jnp.einsum("cmn,cmp->cnp", SA, SA)
        return mean, cov
    kdiag = kernel.diag(kp, X)
    var = kdiag[None, :] - jnp.sum(A * A, axis=0)[None, :] \
        + jnp.sum(SA * SA, axis=1)                 # (C, Nb)
    return mean, jnp.maximum(var.T, 1e-12)


def _kl_whitened(q_mu, q_L):
    """KL( N(q_mu, q_L q_L^T) || N(0, I) ), summed over C latents."""
    M = q_mu.shape[0]
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(q_L, axis1=-2, axis2=-1)))
    tr = jnp.sum(q_L * q_L)
    return 0.5 * (tr + jnp.sum(q_mu * q_mu) - q_mu.size - logdet)


def svgp_elbo(kernel: Kernel, likelihood: Likelihood, params: dict,
              X_batch: jnp.ndarray, y_batch: jnp.ndarray, num_data: int,
              jitter: Optional[float] = None, key=None) -> jnp.ndarray:
    """Minibatch ELBO: (N/b) sum_batch E_q[log p(y_i|f_i)] - KL. ``key``
    drives the MC expectations of likelihoods without quadrature rules
    (Softmax) — fresh noise per step instead of a frozen sample set."""
    q_L = _build_L(params["q_sqrt_raw"])
    mean, var = _whitened_q_f(kernel, params["kernel"], params["Z"],
                              params["q_mu"], q_L, X_batch, jitter)
    if isinstance(likelihood, Softmax):
        ve = likelihood.variational_expectation(params.get("lik", {}), mean,
                                                var, y_batch, key=key)
    else:
        ve = likelihood.variational_expectation(params.get("lik", {}),
                                                mean[:, 0], var[:, 0], y_batch)
    scale = num_data / X_batch.shape[0]
    return scale * jnp.sum(ve) - _kl_whitened(params["q_mu"], q_L)


def svgp_predict_f(kernel: Kernel, params: dict, X_test: jnp.ndarray,
                   jitter: Optional[float] = None, full_cov: bool = False):
    q_L = _build_L(params["q_sqrt_raw"])
    return _whitened_q_f(kernel, params["kernel"], params["Z"],
                         params["q_mu"], q_L, X_test, jitter, full_cov)


class StochasticVariationalGP:
    """Reference API (models/svgp.py:24): ctor
    ``(train_x, train_y, likelihood, Z_init)``, ``train_model``,
    ``posterior_predictive``."""

    def __init__(self, train_x, train_y, likelihood: Likelihood | None = None,
                 Z_init=None, kernel: Kernel | None = None,
                 jitter: float | None = None):
        self.train_x = jnp.asarray(train_x)
        self.train_y = jnp.asarray(train_y)
        d = self.train_x.shape[-1]
        self.kernel = kernel if kernel is not None else default_rbf(ard=True)
        self.likelihood = likelihood if likelihood is not None else GaussianLikelihood()
        self.jitter = default_jitter(self.train_x.dtype) if jitter is None else jitter
        Z_init = jnp.asarray(Z_init) if Z_init is not None else self.train_x[:128]
        Z_init = Z_init.astype(self.train_x.dtype)
        M = Z_init.shape[0]
        C = self.likelihood.num_classes if isinstance(self.likelihood, Softmax) else 1
        self.num_latents = C
        dt = self.train_x.dtype
        self.params = {
            "kernel": self.kernel.init_params(d),
            "lik": self.likelihood.init_params(),
            "Z": Z_init,
            "q_mu": jnp.zeros((M, C), dt),
            # raw diag 0 -> L diag exp(0)=1 (prior init, whitened)
            "q_sqrt_raw": jnp.zeros((C, M, M), dt),
        }

    def loss_fn(self, params, X_batch, y_batch):
        return -svgp_elbo(self.kernel, self.likelihood, params, X_batch,
                          y_batch, self.train_x.shape[0], self.jitter)

    def train_model(self, optimizer=None, num_epochs: int = 100,
                    batch_size: int = 200, lr: float = 0.01, key=None,
                    verbose: bool = False):
        """Jitted SVI: per-epoch permutation, per-step dynamic-slice batches
        (reference loop: models/svgp.py:93-127). Returns per-epoch losses."""
        if key is None:
            key = jax.random.PRNGKey(0)
        N = self.train_x.shape[0]
        batch_size = min(batch_size, N)
        steps = N // batch_size
        if optimizer is None:
            optimizer = optax.adam(lr)
        self.params, losses = _run_svi(
            self.kernel, self.likelihood, self.train_x, self.train_y,
            self.jitter, self.params, optimizer, num_epochs, batch_size,
            steps, key)
        if verbose:
            print(f"SVGP: epoch loss {float(losses[0]):.3f} -> "
                  f"{float(losses[-1]):.3f}")
        return losses

    def posterior_predictive(self, test_x, full_cov: bool = False,
                             include_likelihood: bool = True):
        """q(f*) or the y-predictive (reference returns the y-predictive
        under fast_pred_var, models/svgp.py:132-141)."""
        test_x = jnp.asarray(test_x)
        mean, var = svgp_predict_f(self.kernel, self.params, test_x,
                                   self.jitter, full_cov)
        if full_cov:
            if include_likelihood and isinstance(self.likelihood,
                                                 GaussianLikelihood):
                noise = jnp.exp(self.params["lik"]["log_noise"])
                var = var + noise * jnp.eye(test_x.shape[0], dtype=var.dtype)
            if self.num_latents == 1:
                return mean[:, 0], var[0]
            return mean, var
        if not include_likelihood:
            if self.num_latents == 1:
                return mean[:, 0], var[:, 0]
            return mean, var
        if isinstance(self.likelihood, Softmax):
            # explicit fixed key: the MC class-probability estimate is a
            # deterministic approximation by choice here; pass key= for
            # stochastic estimates
            return self.likelihood.predictive(self.params["lik"], mean, var,
                                              key=jax.random.PRNGKey(0))
        m, v = self.likelihood.predictive(self.params["lik"], mean[:, 0],
                                          var[:, 0])
        return m, v

    @property
    def Z(self):
        return self.params["Z"]


@partial(jax.jit, static_argnums=(0, 1, 6, 7, 8, 9))
def _run_svi(kernel, likelihood, X, y, jitter, params, optimizer, num_epochs,
             batch_size, steps_per_epoch, key):
    N = X.shape[0]
    opt_state = optimizer.init(params)

    def epoch(carry, ekey):
        p, s = carry
        perm = jax.random.permutation(ekey, N)[:steps_per_epoch * batch_size]
        idx = perm.reshape(steps_per_epoch, batch_size)

        skeys = jax.random.split(jax.random.fold_in(ekey, 1),
                                 idx.shape[0])

        def step(carry, inp):
            p, s = carry
            bidx, bkey = inp
            xb, yb = X[bidx], y[bidx]

            def loss(q):
                return -svgp_elbo(kernel, likelihood, q, xb, yb, N, jitter,
                                  key=bkey)

            val, g = jax.value_and_grad(loss)(p)
            # zero_nans-style guard: a borderline non-PSD Kmm or an
            # overflowed poisson rate must not poison optimizer state for
            # the rest of training
            g = jax.tree_util.tree_map(
                lambda a: jnp.where(jnp.isfinite(a), a, 0.0), g)
            updates, s = optimizer.update(g, s, p)
            return (optax.apply_updates(p, updates), s), val

        (p, s), vals = jax.lax.scan(step, (p, s), (idx, skeys))
        return (p, s), jnp.mean(vals)

    ekeys = jax.random.split(key, num_epochs)
    (params, _), losses = jax.lax.scan(epoch, (params, opt_state), ekeys)
    return params, losses

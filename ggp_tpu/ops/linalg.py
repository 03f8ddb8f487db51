"""Linear-algebra core.

This is the layer the reference outsources to GPyTorch/LinearOperator,
Theano, and TF (SURVEY §2.4) — here it is a thin, fully-jittable wrapper over
XLA's batched Cholesky/triangular-solve (cuSOLVER/cuBLAS on the GPU),
plus the jitter and PSD-guard policies the reference scatters as try/except
blocks (models/bayesian_sgpr_hmc.py:225-229, models/gpr_hmc.py:113-117).

Everything here vmaps cleanly (used for vmapped HMC chains and mixture
predictives) and works under pjit sharding.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..config import default_jitter

__all__ = [
    "add_jitter",
    "safe_cholesky",
    "cholesky_with_flag",
    "tri_solve",
    "chol_solve",
    "logdet_from_chol",
    "mvn_logpdf_chol",
    "diag_gaussian_logpdf",
]


def add_jitter(K: jnp.ndarray, jitter: float | None = None,
               relative: bool = False) -> jnp.ndarray:
    """K + jitter*I; with ``relative=True`` the jitter is scaled by the mean
    diagonal (floored at 1), so conditioning tracks a growing outputscale —
    important for f32 Kmm factorisations during hyper optimisation/sampling
    (the reference hand-tunes absolute jitters per site instead,
    experiments/regression.py:34, models/bayesian_sgpr_hmc.py:226)."""
    if jitter is None:
        jitter = default_jitter(K.dtype)
    if relative:
        scale = jnp.maximum(jnp.mean(jnp.diagonal(K, axis1=-2, axis2=-1),
                                     axis=-1), 1.0)
        jitter = jitter * scale[..., None, None] if K.ndim > 2 else jitter * scale
    return K + jitter * jnp.eye(K.shape[-1], dtype=K.dtype)


def safe_cholesky(K: jnp.ndarray, jitter: float | None = None,
                  relative: bool = False) -> jnp.ndarray:
    """Lower Cholesky of K + jitter*I."""
    return jnp.linalg.cholesky(add_jitter(K, jitter, relative))


def cholesky_with_flag(K: jnp.ndarray, jitter: float | None = None):
    """Cholesky plus a PSD-success flag.

    Functional replacement for the reference's try/except
    ``torch.linalg.cholesky`` filters on mixture-predictive components
    (models/bayesian_sgpr_hmc.py:225-229): non-PSD samples are *flagged*
    (and later masked out of the mixture) instead of skipped host-side, so
    the whole mixture stays inside one jitted program.
    """
    L = safe_cholesky(K, jitter)
    ok = jnp.all(jnp.isfinite(L), axis=(-2, -1))       # per batch component
    L = jnp.where(ok[..., None, None], L,
                  jnp.eye(K.shape[-1], dtype=K.dtype))
    return L, ok


def tri_solve(L: jnp.ndarray, b: jnp.ndarray, lower: bool = True,
              trans: bool = False) -> jnp.ndarray:
    return solve_triangular(L, b, lower=lower, trans=1 if trans else 0)


def chol_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L^T) x = b given lower Cholesky L."""
    return tri_solve(L, tri_solve(L, b), trans=True)


def logdet_from_chol(L: jnp.ndarray) -> jnp.ndarray:
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def mvn_logpdf_chol(y: jnp.ndarray, mean: jnp.ndarray, L: jnp.ndarray) -> jnp.ndarray:
    """log N(y | mean, L L^T) for a single (n,) observation."""
    n = y.shape[-1]
    alpha = tri_solve(L, y - mean)
    quad = jnp.sum(alpha * alpha, axis=-1)
    return -0.5 * (quad + logdet_from_chol(L)
                   + n * jnp.log(2.0 * jnp.asarray(jnp.pi, y.dtype)))


def diag_gaussian_logpdf(y: jnp.ndarray, mean: jnp.ndarray, var: jnp.ndarray) -> jnp.ndarray:
    """Elementwise log N(y | mean, var)."""
    return -0.5 * (jnp.log(2.0 * jnp.pi * var) + (y - mean) ** 2 / var)

"""SGPR — Titsias (2009) collapsed variational sparse GP regression.

Rebuild of the reference's ``SparseGPR`` (models/sgpr.py:22-160), which wraps
gpytorch's ``InducingPointKernel`` and trains via an interpreted Python Adam
loop (models/sgpr.py:110-144). Here the collapsed bound is written in closed
form around one Cholesky factorisation pattern and the entire training loop is
a single ``lax.scan`` under ``jit`` — no Python in the hot path, and the same
``elbo`` function is reused as the HMC target for the Bayesian models
(models/bayesian_sgpr_hmc.py uses the identical VFE marginal via pymc3).

Math (matmul-dominant):
  L  = chol(Kmm + jitter I)
  A  = L^-1 Kmn / sigma                  (M x N)
  B  = I + A A^T ;  LB = chol(B)
  c  = LB^-1 A y / sigma
  ELBO = -N/2 log(2 pi) - sum log diag LB - N/2 log sigma^2
         - (y^T y / sigma^2 - c^T c)/2
         - (sum k_diag - sigma^2 ||A||_F^2) / (2 sigma^2)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from ..config import default_jitter
from ..kernels import Kernel, default_rbf
from ..likelihoods import GaussianLikelihood
from jax.scipy.linalg import solve_triangular

from ..ops.linalg import logdet_from_chol, safe_cholesky, tri_solve

__all__ = ["sgpr_elbo", "sgpr_elbo_fast", "sgpr_hmc_target_elbo",
           "sgpr_predict", "sgpr_optimal_qu", "SparseGPR", "vfe_stats",
           "sgpr_elbo_from_stats"]


def vfe_stats(kernel: Kernel, kp: dict, Z: jnp.ndarray, X: jnp.ndarray,
              y: jnp.ndarray) -> dict:
    """Sufficient statistics of the collapsed VFE bound over a row block.

    All four are additive over N — the basis of the data-sharded /
    streamed big-N path (SURVEY §5.7): each device computes its local block
    and a ``psum`` over the data axis yields the global stats. Forms
    S_kk = Kmn Knm as one large matmul per block.
    """
    Kmn = kernel.gram(kp, Z, X)                      # (M, Nb)
    return {
        "S_kk": Kmn @ Kmn.T,                         # (M, M)
        "S_ky": Kmn @ y,                             # (M,)
        "s_kdiag": jnp.sum(kernel.diag(kp, X)),
        "s_yy": jnp.sum(y * y),
    }


def sgpr_elbo_from_stats(kernel: Kernel, params: dict, stats: dict, n: int,
                         jitter: Optional[float] = None,
                         f64_core: Optional[bool] = None) -> jnp.ndarray:
    """Collapsed VFE bound from :func:`vfe_stats` (identical value to
    :func:`sgpr_elbo` up to fp error; squares the Kmn condition number, so
    prefer the direct path when N fits on one device).

    ``f64_core``: run the O(M^2) epilogue — the grams, solves and Cholesky
    factorisations — in float64 regardless of input dtype (default:
    ``GGP_STATS_F64=1``; requires ``jax_enable_x64``). The stats
    formulation loses cond(Kmn)^2 digits; the f64 epilogue extends the
    finite envelope of ~1M-row scaled-stats targets without the O(N) cost
    of f64 stats. At collapsed-outputscale/large-lengthscale modes the f32
    S_kk is itself non-PSD beyond any epilogue precision — f64 stats would
    be required there.
    """
    import os as _os
    if f64_core is None:
        f64_core = bool(_os.environ.get("GGP_STATS_F64"))
    if f64_core and jax.config.read("jax_enable_x64"):
        work = jnp.float64
        stats = {k: jnp.asarray(v, work) for k, v in stats.items()}
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, work), params)
    Z = params["Z"]
    M = Z.shape[0]
    sigma2 = jnp.exp(params["log_noise"])
    Kmm = kernel.gram(params["kernel"], Z, Z)
    L = safe_cholesky(Kmm, jitter, relative=True)
    # AA^T = L^-1 S_kk L^-T / sigma^2
    T = tri_solve(L, stats["S_kk"])
    AAt = tri_solve(L, T.T).T / sigma2               # (M, M), symmetric
    B = AAt + jnp.eye(M, dtype=AAt.dtype)
    LB = safe_cholesky(B, 0.0)
    diag_LB = jnp.diagonal(LB)
    Ay = tri_solve(L, stats["S_ky"]) / jnp.sqrt(sigma2)
    c = tri_solve(LB, Ay) / jnp.sqrt(sigma2)

    bound = -0.5 * n * jnp.log(2.0 * jnp.pi * sigma2)
    bound -= jnp.sum(jnp.log(diag_LB))
    bound -= 0.5 * (stats["s_yy"] / sigma2 - jnp.sum(c * c))
    bound -= 0.5 * (stats["s_kdiag"] - sigma2 * jnp.trace(AAt)) / sigma2
    return bound


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def _bound_core(Kmm_j, stats, log_noise, n, jitter=1e-6):
    """Collapsed bound from (jittered Kmm, stats, log_noise) with a
    hand-derived backward pass.

    The forward uses exactly TWO batched linalg calls — one stacked
    Cholesky of [Kmm, M1=Kmm+S_kk/sigma^2] and one stacked triangular
    inverse (autodiff of the straightforward bound emits ~6) — and the
    backward is pure dense algebra over the saved inverses:

      F = c - (log|M1| - log|Kmm| + n log s2)/2 - s_yy/(2 s2)
          + S_ky^T M1^-1 S_ky/(2 s2^2) - (s_kdiag - tr(Kmm^-1 S_kk))/(2 s2)
    """
    F, _ = _bound_core_fwd(Kmm_j, stats, log_noise, n, jitter)
    return F


def _bound_core_fwd(Kmm_j, stats, log_noise, n, jitter=1e-6):
    M = Kmm_j.shape[0]
    s2 = jnp.exp(log_noise)
    S_kk, S_ky = stats["S_kk"], stats["S_ky"]
    M1 = Kmm_j + S_kk / s2
    # S_kk is a Gram-of-Gram: f32 rounding makes it indefinite at the
    # ~1e-7*||S_kk|| level, which /s2 amplifies past Kmm's small eigenvalues
    # — without this relative jitter the stacked Cholesky NaNs at small
    # noise in f32 (symmetrise + scale-aware floor)
    M1 = 0.5 * (M1 + M1.T)
    m1_scale = jnp.maximum(jnp.mean(jnp.diagonal(M1)), 1.0)
    M1 = M1 + (jitter * m1_scale) * jnp.eye(M, dtype=M1.dtype)
    Ls = jnp.linalg.cholesky(jnp.stack([Kmm_j, M1]))        # 1 batched call
    eye = jnp.broadcast_to(jnp.eye(M, dtype=Kmm_j.dtype), (2, M, M))
    Winv = solve_triangular(Ls, eye, lower=True)            # 1 batched call
    W, W1 = Winv[0], Winv[1]                                # L^-1, L1^-1
    Kinv = W.T @ W
    P = W1.T @ W1
    a = P @ S_ky
    q = S_ky @ a
    t = jnp.sum(Kinv * S_kk)
    logdet_K = 2.0 * jnp.sum(jnp.log(jnp.diagonal(Ls[0])))
    logdet_M1 = 2.0 * jnp.sum(jnp.log(jnp.diagonal(Ls[1])))
    F = (-0.5 * n * jnp.log(2.0 * jnp.pi)
         - 0.5 * (logdet_M1 - logdet_K + n * jnp.log(s2))
         - stats["s_yy"] / (2.0 * s2)
         + q / (2.0 * s2 ** 2)
         - (stats["s_kdiag"] - t) / (2.0 * s2))
    res = (Kinv, P, a, q, t, S_kk, S_ky, s2,
           stats["s_yy"], stats["s_kdiag"])
    return F, res


def _bound_core_bwd(n, res, gF):
    Kinv, P, a, q, t, S_kk, S_ky, s2, s_yy, s_kdiag = res
    s4, s6, s8 = s2 ** 2, s2 ** 3, s2 ** 4
    aaT = jnp.outer(a, a)
    dKmm = -0.5 * P + 0.5 * Kinv - aaT / (2.0 * s4) \
        - (Kinv @ S_kk @ Kinv) / (2.0 * s2)
    dS_kk = -P / (2.0 * s2) - aaT / (2.0 * s6) + Kinv / (2.0 * s2)
    dS_ky = a / s4
    ds_yy = -1.0 / (2.0 * s2)
    ds_kdiag = -1.0 / (2.0 * s2)
    dF_ds2 = (-n / (2.0 * s2) + jnp.sum(P * S_kk) / (2.0 * s4)
              + (a @ (S_kk @ a)) / (2.0 * s8) - q / s6
              + s_yy / (2.0 * s4) + (s_kdiag - t) / (2.0 * s4))
    dlog_noise = dF_ds2 * s2
    dstats = {"S_kk": gF * dS_kk, "S_ky": gF * dS_ky,
              "s_yy": gF * ds_yy, "s_kdiag": gF * ds_kdiag}
    # jitter is a regularisation knob, not a model parameter: zero cotangent
    return (gF * dKmm, dstats, gF * dlog_noise, jnp.zeros_like(dlog_noise))


_bound_core.defvjp(lambda K, s, l, n, j: _bound_core_fwd(K, s, l, n, j),
                   _bound_core_bwd)


def sgpr_hmc_target_elbo():
    """The collapsed-bound implementation used as HMC leapfrog target.

    DEFAULT: the direct Cholesky bound (:func:`sgpr_elbo`). The
    2-linalg-call variant (:func:`sgpr_elbo_fast`) works in the stats
    formulation, whose f32 gradients lose cond(Kmn)^2 digits — at realistic
    (small-noise) hypers in f32 they are unusable, so it is OPT-IN via
    ``GGP_FAST_ELBO=1`` (safe under x64 or well-conditioned problems). Read
    at TRACE time — toggling after a sampler is compiled has no effect on
    the cached executable.
    """
    import os as _os
    return sgpr_elbo_fast if _os.environ.get("GGP_FAST_ELBO") else sgpr_elbo


def sgpr_elbo_fast(kernel: Kernel, params: dict, X: jnp.ndarray,
                   y: jnp.ndarray, jitter: Optional[float] = None) -> jnp.ndarray:
    """Collapsed VFE bound, linalg-call-minimised variant (see _bound_core).

    Same value as :func:`sgpr_elbo` up to fp reassociation; preferred as the
    HMC leapfrog target. Note it squares Kmn's condition number (stats
    formulation) — with the relative jitter policy this is fine in f32 for
    normalised data.
    """
    from ..config import default_jitter as _dj
    if jitter is None:
        jitter = _dj(X.dtype)
    kp = params["kernel"]
    Z = params["Z"]
    from ..ops.linalg import add_jitter
    stats = vfe_stats(kernel, kp, Z, X, y)
    Kmm_j = add_jitter(kernel.gram(kp, Z, Z), jitter, relative=True)
    return _bound_core(Kmm_j, stats, params["log_noise"], X.shape[0],
                       jnp.asarray(jitter, X.dtype))


def _common(kernel: Kernel, params: dict, X: jnp.ndarray, y: jnp.ndarray,
            jitter: Optional[float] = None):
    """Shared factorisation for bound + predictions."""
    Z = params["Z"]
    kp = params["kernel"]
    sigma2 = jnp.exp(params["log_noise"])
    sigma = jnp.sqrt(sigma2)

    Kmm = kernel.gram(kp, Z, Z)
    Kmn = kernel.gram(kp, Z, X)
    L = safe_cholesky(Kmm, jitter, relative=True)
    A = tri_solve(L, Kmn) / sigma                       # (M, N)
    B = A @ A.T + jnp.eye(Z.shape[0], dtype=X.dtype)
    LB = safe_cholesky(B, 0.0)
    Ay = A @ y
    c = tri_solve(LB, Ay) / sigma                       # (M,)
    return dict(Z=Z, kp=kp, sigma2=sigma2, sigma=sigma, L=L, A=A, LB=LB, c=c)


def sgpr_elbo(kernel: Kernel, params: dict, X: jnp.ndarray, y: jnp.ndarray,
              jitter: Optional[float] = None) -> jnp.ndarray:
    """Collapsed VFE bound (total over N, matching the reference's
    ``-mll(output, y).sum()`` convention at models/sgpr.py:125)."""
    n = X.shape[0]
    f = _common(kernel, params, X, y, jitter)
    sigma2, A, LB, c = f["sigma2"], f["A"], f["LB"], f["c"]
    kdiag_sum = jnp.sum(kernel.diag(f["kp"], X))
    qdiag_sum = sigma2 * jnp.sum(A * A)                 # tr(Qnn)

    bound = -0.5 * n * jnp.log(2.0 * jnp.pi * sigma2)
    bound -= jnp.sum(jnp.log(jnp.diagonal(LB)))
    bound -= 0.5 * (jnp.sum(y * y) / sigma2 - jnp.sum(c * c))
    bound -= 0.5 * (kdiag_sum - qdiag_sum) / sigma2     # Titsias trace term
    return bound


def sgpr_predict(kernel: Kernel, params: dict, X: jnp.ndarray, y: jnp.ndarray,
                 X_test: jnp.ndarray, jitter: Optional[float] = None,
                 full_cov: bool = False, include_noise: bool = True):
    """Posterior predictive q(f*) (optionally + observation noise).

    Mirrors ``SparseGPR.posterior_predictive`` (models/sgpr.py:150-160) which
    returns the y-predictive (noise included).
    """
    f = _common(kernel, params, X, y, jitter)
    Kts = kernel.gram(f["kp"], f["Z"], X_test)          # (M, Nt)
    tmp1 = tri_solve(f["L"], Kts)                       # L^-1 Km*
    tmp2 = tri_solve(f["LB"], tmp1)                     # LB^-1 L^-1 Km*
    mean = tmp2.T @ f["c"]
    if full_cov:
        Ktt = kernel.gram(f["kp"], X_test, X_test)
        cov = Ktt - tmp1.T @ tmp1 + tmp2.T @ tmp2
        if include_noise:
            cov = cov + f["sigma2"] * jnp.eye(X_test.shape[0], dtype=X.dtype)
        return mean, cov
    ktt = kernel.diag(f["kp"], X_test)
    var = ktt - jnp.sum(tmp1 * tmp1, axis=0) + jnp.sum(tmp2 * tmp2, axis=0)
    var = jnp.maximum(var, 1e-12)
    if include_noise:
        var = var + f["sigma2"]
    return mean, var


def sgpr_optimal_qu(kernel: Kernel, params: dict, X: jnp.ndarray, y: jnp.ndarray,
                    jitter: Optional[float] = None):
    """Optimal q*(u) = N(m_u, S_u) (reference: ``optimal_q_u``,
    models/sgpr.py:147-148, and the hand-derivation kept in comments at
    models/sgpr.py:256-289)."""
    f = _common(kernel, params, X, y, jitter)
    # m_u = L LB^-T c ; S_u = L B^-1 L^T
    m_u = f["L"] @ tri_solve(f["LB"], f["c"], trans=True)
    tmp = tri_solve(f["LB"], f["L"].T)                  # LB^-1 L^T
    S_u = tmp.T @ tmp
    return m_u, S_u


class SparseGPR:
    """Stateful convenience wrapper with the reference's public API
    (ctor ``(train_x, train_y, likelihood, Z_init)``, ``train_model``,
    ``posterior_predictive``, ``optimal_q_u`` — models/sgpr.py:22-160).

    All heavy work delegates to the pure functions above; ``self.params`` is
    the single source of mutable state.
    """

    def __init__(self, train_x, train_y, likelihood: GaussianLikelihood | None = None,
                 Z_init=None, kernel: Kernel | None = None, jitter: float | None = None):
        self.train_x = jnp.asarray(train_x)
        self.train_y = jnp.asarray(train_y)
        d = self.train_x.shape[-1]
        self.kernel = kernel if kernel is not None else default_rbf(ard=True)
        self.likelihood = likelihood if likelihood is not None else GaussianLikelihood()
        self.jitter = default_jitter(self.train_x.dtype) if jitter is None else jitter
        Z_init = jnp.asarray(Z_init) if Z_init is not None else self.train_x[:128]
        self.params = {
            "kernel": self.kernel.init_params(d),
            "log_noise": jnp.zeros((), self.train_x.dtype),
            "Z": Z_init.astype(self.train_x.dtype),
        }

    # -- training ------------------------------------------------------------
    def loss_fn(self, params):
        return -sgpr_elbo(self.kernel, params, self.train_x, self.train_y,
                          self.jitter)

    def train_model(self, optimizer=None, max_steps: int = 2000, lr: float = 0.01,
                    log_interval: int = 1000, verbose: bool = True):
        """Adam on (theta, Z) via one jitted lax.scan (reference loop:
        models/sgpr.py:110-144). Returns the per-step loss trajectory."""
        if optimizer is None:
            # clip guards against Cholesky-gradient blow-ups on
            # ill-conditioned composite kernels in f32
            optimizer = optax.chain(optax.zero_nans(),
                                    optax.clip_by_global_norm(100.0),
                                    optax.adam(lr))
        params, losses = _run_adam(self.kernel, self.train_x, self.train_y,
                                   self.jitter, self.params, optimizer, max_steps)
        self.params = params
        if verbose and log_interval:
            for j in range(0, max_steps, log_interval):
                print(f"Iter {j}/{max_steps} - Loss: {float(losses[j]):.3f}")
        return losses

    # -- prediction ----------------------------------------------------------
    def posterior_predictive(self, test_x, full_cov: bool = True,
                             include_noise: bool = True):
        return sgpr_predict(self.kernel, self.params, self.train_x,
                            self.train_y, jnp.asarray(test_x), self.jitter,
                            full_cov=full_cov, include_noise=include_noise)

    def optimal_q_u(self):
        return sgpr_optimal_qu(self.kernel, self.params, self.train_x,
                               self.train_y, self.jitter)

    @property
    def Z(self):
        return self.params["Z"]

    @property
    def noise(self):
        return jnp.exp(self.params["log_noise"])


@partial(jax.jit, static_argnums=(0, 5, 6, 7))
def _run_adam(kernel, X, y, jitter, params, optimizer, max_steps,
              min_noise=1e-4):
    """One jitted Adam scan. ``min_noise`` projects log_noise onto a floor
    after every step — f32 ML-II otherwise collapses the noise and NaNs the
    Cholesky (the reference's CO2 baseline constrains noise >= 5e-4 for the
    same reason, experiments/co2_baseline.py:158)."""
    opt_state = optimizer.init(params)

    def loss(p):
        return -sgpr_hmc_target_elbo()(kernel, p, X, y, jitter)

    def step(carry, _):
        p, s = carry
        val, g = jax.value_and_grad(loss)(p)
        updates, s = optimizer.update(g, s, p)
        p = optax.apply_updates(p, updates)
        # box-project log HYPER params only: |log theta| > 15 is always
        # degenerate and exp() overflows f32 past ~88 -> NaN cascades.
        # Z is a location, not a log-param - never clamp it (CO2 time axes
        # legitimately exceed the box).
        p = {k: (v if k == "Z" else
                 jax.tree_util.tree_map(lambda a: jnp.clip(a, -15.0, 15.0), v))
             for k, v in p.items()}
        if min_noise is not None and "log_noise" in p:
            p["log_noise"] = jnp.maximum(p["log_noise"],
                                         jnp.log(jnp.asarray(min_noise)))
        return (p, s), val

    (params, _), losses = jax.lax.scan(step, (params, opt_state), None,
                                       length=max_steps)
    return params, losses

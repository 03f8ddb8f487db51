"""Plain float64 numpy references for the model targets.

Each function re-derives one target from its textbook formula with numpy
(and scipy's special functions) only: pairwise grams from explicit
differences, ``np.linalg`` factorisations, no JAX and no other ggp_tpu
code. The tests and ``chip_smoke.py`` compare the package's jitted value and
gradient with these; the gradient side of the comparison is a central
difference of the numpy value (:func:`central_diff_grad`,
:func:`directional_diff`).

Conventions shared with the package (and so restated here on purpose):
parameters are unconstrained logs (``log_outputscale`` = log variance,
``log_noise`` = log noise variance); Kmm jitter is relative to the mean of
its diagonal, floored at 1; hyper-priors act on ``x = exp(u)`` with the log
Jacobian folded in.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import gammaln, log_ndtr

__all__ = ["rbf_ard", "co2_gram", "titsias_bound", "log_prior_np",
           "sgpr_neg_logpost", "gpr_neg_logpost", "sgpmc_logpost",
           "svgp_elbo", "bsvgp_elbo", "central_diff_grad",
           "directional_diff"]


# ---------------------------------------------------------------------------
# grams
# ---------------------------------------------------------------------------

def rbf_ard(X1, X2, log_ls, log_os):
    """sigma_f^2 exp(-0.5 sum_d (x_d - z_d)^2 / l_d^2)."""
    ls = np.exp(np.asarray(log_ls, np.float64))
    diff = (np.asarray(X1)[:, None, :] - np.asarray(X2)[None, :, :]) / ls
    return math.exp(float(log_os)) * np.exp(-0.5 * np.sum(diff * diff, -1))


def co2_gram(t1, t2, p, noise_component="rbf"):
    """Mauna Loa composite on 1-D inputs: Scale(Periodic(p=1) x RBF) +
    Scale(RBF) + Scale(RQ) + Scale(RBF | Matern32). ``p`` is the package's
    co2_kernel parameter tree (numbers or 0-d arrays)."""
    e = lambda v: math.exp(float(v))  # noqa: E731
    seas, trend, med, nz = p["terms"]
    t = np.asarray(t1, np.float64).reshape(-1)[:, None] \
        - np.asarray(t2, np.float64).reshape(-1)[None, :]
    per_ls = e(seas["base"]["terms"][0]["log_lengthscale"])
    prbf_ls = e(seas["base"]["terms"][1]["log_lengthscale"])
    k = e(seas["log_outputscale"]) \
        * np.exp(-2.0 * np.sin(np.pi * t) ** 2 / per_ls ** 2) \
        * np.exp(-0.5 * (t / prbf_ls) ** 2)
    k = k + e(trend["log_outputscale"]) * np.exp(
        -0.5 * (t / e(trend["base"]["log_lengthscale"])) ** 2)
    alpha = e(med["base"]["log_alpha"])
    k = k + e(med["log_outputscale"]) * (
        1.0 + (t / e(med["base"]["log_lengthscale"])) ** 2 / (2.0 * alpha)
    ) ** (-alpha)
    r = np.abs(t) / e(nz["base"]["log_lengthscale"])
    if noise_component == "matern32":
        r3 = math.sqrt(3.0) * r
        k = k + e(nz["log_outputscale"]) * (1.0 + r3) * np.exp(-r3)
    else:
        k = k + e(nz["log_outputscale"]) * np.exp(-0.5 * r ** 2)
    return k


def _rel_chol(K, jitter):
    jit = jitter * max(float(np.mean(np.diag(K))), 1.0)
    return np.linalg.cholesky(K + jit * np.eye(K.shape[0]))


# ---------------------------------------------------------------------------
# collapsed (Titsias 2009) bound and the hyper-priors
# ---------------------------------------------------------------------------

def titsias_bound(Kmm, Kmn, kdiag, y, log_noise, jitter):
    """Collapsed VFE bound log N(y | 0, Qnn + s2 I) - tr(Knn - Qnn)/(2 s2)."""
    n, m = Kmn.shape[1], Kmm.shape[0]
    L = _rel_chol(Kmm, jitter)
    sigma2 = math.exp(float(log_noise))
    A = np.linalg.solve(L, Kmn) / math.sqrt(sigma2)
    B = A @ A.T + np.eye(m)
    LB = np.linalg.cholesky(B)
    c = np.linalg.solve(LB, A @ y) / math.sqrt(sigma2)
    bound = -0.5 * n * math.log(2.0 * math.pi * sigma2)
    bound -= np.sum(np.log(np.diag(LB)))
    bound -= 0.5 * (y @ y / sigma2 - c @ c)
    bound -= 0.5 * (np.sum(kdiag) - sigma2 * np.sum(A * A)) / sigma2
    return float(bound)


def _prior_leaf(prior, u):
    """log p(x = exp(u)) + u for one prior object (its class name and
    fields), summed over the elements of u."""
    u = np.asarray(u, np.float64)
    name = type(prior).__name__
    if name == "Flat":
        return 0.0
    if name in ("LogNormal", "Normal"):
        z = (u - prior.mu) / prior.sigma
        return float(np.sum(-0.5 * z * z - math.log(prior.sigma)
                            - 0.5 * math.log(2.0 * math.pi)))
    x = np.exp(u)
    if name == "Gamma":
        a, b = prior.alpha, prior.beta
        lp = a * math.log(b) - math.lgamma(a) + (a - 1.0) * np.log(x) - b * x
    elif name == "HalfCauchy":
        s = prior.scale
        lp = math.log(2.0 / (math.pi * s)) - np.log(1.0 + (x / s) ** 2)
    elif name == "HalfNormal":
        s = prior.scale
        lp = 0.5 * math.log(2.0 / math.pi) - math.log(s) - 0.5 * (x / s) ** 2
    elif name == "HalfCauchyOnStd":
        # prior on the std s = sqrt(x); Jacobian ds/du = s/2
        s, sc = np.sqrt(x), prior.scale
        return float(np.sum(math.log(2.0 / (math.pi * sc))
                            - np.log(1.0 + (s / sc) ** 2) + np.log(0.5 * s)))
    else:
        raise ValueError(f"no numpy reference for prior {name}")
    return float(np.sum(lp + u))


def log_prior_np(prior_tree, params):
    """Sum of :func:`_prior_leaf` over matching nested dicts/tuples."""
    if isinstance(prior_tree, dict):
        return sum(log_prior_np(prior_tree[k], params[k]) for k in prior_tree)
    if isinstance(prior_tree, (tuple, list)):
        return sum(log_prior_np(a, b) for a, b in zip(prior_tree, params))
    return _prior_leaf(prior_tree, params)


def sgpr_neg_logpost(X, y, Z, hypers, jitter, prior_tree=None,
                     kernel="rbf_ard"):
    """-(collapsed bound + log prior): the flagship NUTS potential.
    ``hypers`` = {"kernel": ..., "log_noise": ...} in the package layout;
    ``kernel`` is "rbf_ard" or a CO2 noise component ("rbf"/"matern32")."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    Z = np.asarray(Z, np.float64)
    kp = hypers["kernel"]
    if kernel == "rbf_ard":
        ls, os_ = kp["base"]["log_lengthscale"], kp["log_outputscale"]
        Kmm, Kmn = rbf_ard(Z, Z, ls, os_), rbf_ard(Z, X, ls, os_)
        kdiag = np.full(X.shape[0], math.exp(float(os_)))
    else:
        Kmm, Kmn = co2_gram(Z, Z, kp, kernel), co2_gram(Z, X, kp, kernel)
        kdiag = np.full(X.shape[0], co2_gram([0.0], [0.0], kp, kernel)[0, 0])
    U = -titsias_bound(Kmm, Kmn, kdiag, y, hypers["log_noise"], jitter)
    if prior_tree is not None:
        U -= log_prior_np(prior_tree, hypers)
    return U


def gpr_neg_logpost(X, y, hypers, jitter, prior_tree):
    """-(log N(y | 0, K + s2 I) + log prior) for the dense GPR target
    (absolute jitter on the diagonal)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    kp = hypers["kernel"]
    n = X.shape[0]
    K = rbf_ard(X, X, kp["base"]["log_lengthscale"], kp["log_outputscale"])
    K = K + (math.exp(float(hypers["log_noise"])) + jitter) * np.eye(n)
    L = np.linalg.cholesky(K)
    a = np.linalg.solve(L, y)
    ll = (-0.5 * a @ a - np.sum(np.log(np.diag(L)))
          - 0.5 * n * math.log(2.0 * math.pi))
    return float(-(ll + log_prior_np(prior_tree, hypers)))


# ---------------------------------------------------------------------------
# whitened / uncollapsed targets
# ---------------------------------------------------------------------------

def _whitened_moments(Kmm, Kms, kdiag, jitter, q_mu, q_L=None):
    """q(f) moments under u = L v: mean = A^T q_mu, var = kdiag - |A|^2
    (+ |q_L^T A|^2), A = L^-1 Kms; q_mu (M,) or (M, C), q_L (C, M, M)."""
    A = np.linalg.solve(_rel_chol(Kmm, jitter), Kms)
    mean = A.T @ q_mu
    var = kdiag - np.sum(A * A, axis=0)
    if q_L is not None:
        SA = np.einsum("cmk,mn->ckn", q_L, A)        # q_L^T A per latent
        var = var[:, None] + np.sum(SA * SA, axis=1).T
    return mean, np.maximum(var, 1e-12)


def _gauss_ve(y, mean, var, log_noise):
    s2 = math.exp(float(log_noise))
    return -0.5 * (math.log(2.0 * math.pi * s2) + ((y - mean) ** 2 + var) / s2)


def sgpmc_logpost(X, y, Z, state, jitter, prior_tree):
    """Whitened joint target of SGPMC with a Gaussian likelihood:
    sum_i E_{q(f_i|v)}[log p(y_i|f_i)] + log N(v|0,I) + log p(theta)."""
    X = np.asarray(X, np.float64)
    kp = state["kernel"]
    ls, os_ = kp["base"]["log_lengthscale"], kp["log_outputscale"]
    mean, var = _whitened_moments(
        rbf_ard(Z, Z, ls, os_), rbf_ard(Z, X, ls, os_),
        np.full(X.shape[0], math.exp(float(os_))), jitter,
        np.asarray(state["v"], np.float64))
    lp = np.sum(_gauss_ve(np.asarray(y, np.float64), mean, var,
                          state["lik"]["log_noise"]))
    lp -= 0.5 * np.sum(np.asarray(state["v"]) ** 2)
    return float(lp + log_prior_np(prior_tree, {"kernel": kp,
                                                "lik": state["lik"]}))


def _q_chol(raw):
    """Lower-triangular q_L with exp() diagonal from raw (C, M, M)."""
    raw = np.asarray(raw, np.float64)
    L = np.tril(raw, -1)
    idx = np.arange(raw.shape[-1])
    L[..., idx, idx] = np.exp(raw[..., idx, idx])
    return L


def _kl_std_normal(q_mu, q_L):
    q_mu = np.asarray(q_mu, np.float64)
    logdet = 2.0 * np.sum(np.log(np.diagonal(q_L, axis1=-2, axis2=-1)))
    return 0.5 * (np.sum(q_L * q_L) + np.sum(q_mu * q_mu) - q_mu.size
                  - logdet)


def _variational_expectation(likelihood, y, mean, var, lik_params, eps):
    """E_{N(f|mean,var)}[log p(y|f)], likelihood by name."""
    if likelihood == "gaussian":
        return _gauss_ve(y, mean[:, 0], var[:, 0], lik_params["log_noise"])
    if likelihood == "poisson":
        m, v = mean[:, 0], var[:, 0]
        return y * m - np.exp(m + 0.5 * v) - gammaln(y + 1.0)
    if likelihood == "bernoulli_probit":
        # 100-point Gauss-Hermite: exact to f64 for these smooth integrands
        x, w = np.polynomial.hermite_e.hermegauss(100)
        w = w / w.sum()
        f = mean[:, :1] + np.sqrt(var[:, :1]) * x[None, :]
        return np.sum(log_ndtr((2.0 * y[:, None] - 1.0) * f) * w, axis=1)
    if likelihood == "softmax":
        # the MC estimate on the SAME antithetic normals as the package:
        # eps (S/2, N, C), mirrored
        e = np.concatenate([eps, -eps], axis=0)
        f = mean[None] + np.sqrt(var)[None] * e            # (S, N, C)
        f = f - f.max(-1, keepdims=True)
        logp = f - np.log(np.sum(np.exp(f), -1, keepdims=True))
        lab = np.asarray(y).astype(int)
        return np.mean(np.take_along_axis(
            logp, np.broadcast_to(lab[None, :, None], f.shape[:2] + (1,)),
            axis=-1)[..., 0], axis=0)
    raise ValueError(f"no numpy reference for likelihood {likelihood}")


def svgp_elbo(X, y, params, num_data, jitter, likelihood, eps=None):
    """Minibatch SVGP ELBO (N/b) sum_i E_q[log p(y_i|f_i)] - KL(q(v)||p(v))
    with whitened q(v) = N(q_mu, q_L q_L^T) over C latents."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    kp = params["kernel"]
    ls, os_ = kp["base"]["log_lengthscale"], kp["log_outputscale"]
    Z = np.asarray(params["Z"], np.float64)
    q_L = _q_chol(params["q_sqrt_raw"])
    q_mu = np.asarray(params["q_mu"], np.float64)
    mean, var = _whitened_moments(
        rbf_ard(Z, Z, ls, os_), rbf_ard(Z, X, ls, os_),
        np.full(X.shape[0], math.exp(float(os_))), jitter, q_mu, q_L)
    ve = _variational_expectation(likelihood, y, mean, var,
                                  params.get("lik", {}), eps)
    return float(num_data / X.shape[0] * np.sum(ve)
                 - _kl_std_normal(q_mu, q_L))


def bsvgp_elbo(X, y, params, num_data, jitter, eps, prior_var):
    """Bayesian SVGP ELBO with a Gaussian likelihood: the data term averaged
    over hyper draws theta_s = mu + L_h eps_s (theta = [log os, log ls_1..D,
    log noise std]), minus both KLs."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    d = X.shape[1]
    h = d + 2
    L_h = np.zeros((h, h))
    L_h[np.tril_indices(h)] = np.asarray(params["hyper_L_vec"], np.float64)
    L_h[np.arange(h), np.arange(h)] = np.exp(np.diag(L_h))
    mu_h = np.asarray(params["hyper_mu"], np.float64)
    thetas = mu_h[None] + np.asarray(eps, np.float64) @ L_h.T
    Z = np.asarray(params["Z"], np.float64)
    q_L = _q_chol(params["q_sqrt_raw"])
    q_mu = np.asarray(params["q_mu"], np.float64)
    terms = []
    for s in thetas:
        mean, var = _whitened_moments(
            rbf_ard(Z, Z, s[1:d + 1], s[0]), rbf_ard(Z, X, s[1:d + 1], s[0]),
            np.full(X.shape[0], math.exp(s[0])), jitter, q_mu, q_L)
        terms.append(np.sum(_gauss_ve(y, mean[:, 0], var[:, 0], 2.0 * s[-1])))
    kl_h = 0.5 * (np.sum(L_h * L_h) / prior_var + mu_h @ mu_h / prior_var
                  - h - 2.0 * np.sum(np.log(np.diag(L_h)))
                  + h * math.log(prior_var))
    return float(num_data / X.shape[0] * np.mean(terms)
                 - _kl_std_normal(q_mu, q_L) - kl_h)


# ---------------------------------------------------------------------------
# finite differences
# ---------------------------------------------------------------------------

def _richardson(f, x, v, h):
    """Central difference of f along v, Richardson-extrapolated over the
    steps h and h/2: truncation error O(h^4), so h can stay large enough
    that rounding in f (amplified by ill-conditioned factorisations) does
    not dominate."""
    def d(s):
        return (f(x + s * v) - f(x - s * v)) / (2.0 * s)
    return (4.0 * d(0.5 * h) - d(h)) / 3.0


def central_diff_grad(f, x, rel_step=2e-5):
    """Gradient of scalar f at the flat vector x, one coordinate at a time
    (step relative to max(1, |x_i|))."""
    x = np.asarray(x, np.float64)
    g = np.empty_like(x)
    for i in range(x.size):
        e = np.zeros_like(x)
        e[i] = 1.0
        g[i] = _richardson(f, x, e, rel_step * max(1.0, abs(x[i])))
    return g


def directional_diff(f, x, v, step=2e-5):
    """Approximates grad f(x) . v."""
    return _richardson(f, np.asarray(x, np.float64),
                       np.asarray(v, np.float64), step)

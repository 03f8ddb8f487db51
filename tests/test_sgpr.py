"""SGPR collapsed bound: equals exact GP marginal likelihood as Z -> X, lower
bounds it otherwise, and training recovers hyperparameters (SURVEY §4
implication 2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ggp_tpu.kernels import default_rbf
from ggp_tpu.models.sgpr import SparseGPR, sgpr_elbo, sgpr_optimal_qu, sgpr_predict
from ggp_tpu.ops.linalg import mvn_logpdf_chol, safe_cholesky
from ggp_tpu.utils.load_data import DataConfig, KernelConfig, load_1d_synthetic


def exact_gp_lml(kernel, params, X, y):
    K = kernel.gram(params["kernel"], X, X) + jnp.exp(params["log_noise"]) * jnp.eye(X.shape[0])
    L = safe_cholesky(K, 0.0)
    return mvn_logpdf_chol(y, jnp.zeros_like(y), L)


@pytest.fixture
def data():
    X, y, f = load_1d_synthetic(
        data_cfg=DataConfig(n=60, noise=0.2),
        kernel_cfg=KernelConfig(lengthscale=1.2, outputscale=1.5))
    return X, y


def _params(X, Z):
    kern = default_rbf(ard=True)
    p = {"kernel": kern.init_params(X.shape[1]),
         "log_noise": jnp.log(jnp.asarray(0.04)),
         "Z": Z}
    return kern, p


def test_elbo_equals_lml_when_Z_is_X(data):
    X, y = data
    kern, p = _params(X, X)
    elbo = sgpr_elbo(kern, p, X, y, jitter=1e-10)
    lml = exact_gp_lml(kern, p, X, y)
    np.testing.assert_allclose(float(elbo), float(lml), rtol=1e-6)


def test_elbo_lower_bounds_lml(data):
    X, y = data
    kern, p = _params(X, X[::4])
    elbo = sgpr_elbo(kern, p, X, y, jitter=1e-10)
    lml = exact_gp_lml(kern, p, X, y)
    assert float(elbo) < float(lml) + 1e-8


def test_predictive_matches_exact_gp_when_Z_is_X(data):
    X, y = data
    Xt = jnp.linspace(-5, 5, 23)[:, None]
    kern, p = _params(X, X)
    mean, var = sgpr_predict(kern, p, X, y, Xt, jitter=1e-10, full_cov=False)

    s2 = jnp.exp(p["log_noise"])
    K = kern.gram(p["kernel"], X, X) + s2 * jnp.eye(X.shape[0])
    Ks = kern.gram(p["kernel"], X, Xt)
    L = safe_cholesky(K, 0.0)
    alpha = jax.scipy.linalg.cho_solve((L, True), y)
    mean_e = Ks.T @ alpha
    v = jax.scipy.linalg.solve_triangular(L, Ks, lower=True)
    var_e = kern.diag(p["kernel"], Xt) - jnp.sum(v * v, axis=0) + s2

    np.testing.assert_allclose(np.asarray(mean), np.asarray(mean_e), atol=1e-5)
    np.testing.assert_allclose(np.asarray(var), np.asarray(var_e), rtol=1e-4, atol=1e-6)


def test_optimal_qu_consistent_with_predictive(data):
    """Predicting at Z should reproduce q*(u)'s mean: f(Z) = u."""
    X, y = data
    Z = X[::5]
    kern, p = _params(X, Z)
    m_u, S_u = sgpr_optimal_qu(kern, p, X, y, jitter=1e-10)
    mean, _ = sgpr_predict(kern, p, X, y, Z, jitter=1e-10, full_cov=False,
                           include_noise=False)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(m_u), atol=1e-5)
    assert np.linalg.eigvalsh(np.asarray(S_u)).min() > -1e-8


def test_training_improves_and_recovers_noise(data):
    X, y = data
    Z0 = X[::3]
    model = SparseGPR(X, y, Z_init=Z0)
    losses = model.train_model(max_steps=500, lr=0.05, verbose=False)
    assert float(losses[-1]) < float(losses[0])
    # true observation noise var = 0.04
    assert 0.01 < float(model.noise) < 0.12
    # predictions should be decent
    mean, var = model.posterior_predictive(X, full_cov=False)
    resid = np.asarray(mean) - np.asarray(y)
    assert np.sqrt((resid ** 2).mean()) < 0.35


def test_elbo_gradient_finite(data):
    X, y = data
    kern, p = _params(X, X[::4])
    g = jax.grad(lambda q: sgpr_elbo(kern, q, X, y))(p)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.all(np.isfinite(np.asarray(leaf)))


@pytest.mark.slow
def test_elbo_fast_parity():
    """Custom-VJP fused bound (2 batched custom calls, closed-form backward)
    matches the autodiff path on a WELL-CONDITIONED problem — its documented
    domain: the stats formulation squares cond(Kmn), so ill-conditioned
    inducing sets lose digits by construction (why the direct bound stays
    the default, see sgpr_hmc_target_elbo)."""
    from ggp_tpu.models.sgpr import sgpr_elbo_fast
    rng = np.random.default_rng(7)
    X = jnp.asarray(rng.normal(size=(80, 3)))
    y = jnp.asarray(rng.normal(size=80))
    Z = jnp.asarray(rng.normal(size=(16, 3)))   # random, well-separated
    kern = default_rbf(ard=True)
    p = {"kernel": {"log_outputscale": jnp.asarray(0.3),
                    "base": {"log_lengthscale": jnp.zeros(3)}},
         "log_noise": jnp.log(jnp.asarray(0.1)), "Z": Z}
    v1, g1 = jax.value_and_grad(lambda q: sgpr_elbo(kern, q, X, y, 1e-10))(p)
    v2, g2 = jax.value_and_grad(lambda q: sgpr_elbo_fast(kern, q, X, y, 1e-10))(p)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-9)


def test_stats_bound_f64_core_parity(rng):
    """The f64 M x M epilogue (GGP_STATS_F64 / f64_core=True) matches the
    f32 branch on benign problems, handles M that is not a multiple of 32,
    and never NaNs where the f32 branch is finite. At collapsed-outputscale/
    large-lengthscale modes the f32 STATS are already non-PSD beyond any
    epilogue precision — the f64 core extends the finite envelope but does
    not repair garbage inputs."""
    from ggp_tpu.models.sgpr import sgpr_elbo_from_stats, vfe_stats

    kern = default_rbf(ard=True)
    X = jnp.asarray(rng.normal(size=(300, 6)), jnp.float32)
    y = jnp.asarray(rng.normal(size=300), jnp.float32)
    Z = X[:37]                                   # non-multiple of 32 (pad)
    kp = {"kernel": kern.init_params(6), "log_noise": jnp.zeros(())}
    st = vfe_stats(kern, kp["kernel"], Z, X, y)
    b32 = sgpr_elbo_from_stats(kern, {**kp, "Z": Z}, st, 300, 1e-6,
                               f64_core=False)
    b64 = sgpr_elbo_from_stats(kern, {**kp, "Z": Z}, st, 300, 1e-6,
                               f64_core=True)
    np.testing.assert_allclose(float(b64), float(b32), rtol=1e-4)

    # the rescue case: large lengthscales (near-rank-1 Kmn) x 75-scaled
    # stats in f32 — measured NaN regime of the 1M-row SGHMC target
    kp_bad = {"kernel": {"base": {"log_lengthscale": jnp.full((6,), 2.3,
                                                              jnp.float32)},
                         "log_outputscale": jnp.asarray(-1.1, jnp.float32)},
              "log_noise": jnp.asarray(-0.05, jnp.float32)}
    st_b = vfe_stats(kern, kp_bad["kernel"], Z, X, y)
    st_s = jax.tree_util.tree_map(lambda s: s * 75.0, st_b)
    b32_bad = sgpr_elbo_from_stats(kern, {**kp_bad, "Z": Z}, st_s,
                                   300 * 75, 1e-5, f64_core=False)
    b64_bad = sgpr_elbo_from_stats(kern, {**kp_bad, "Z": Z}, st_s,
                                   300 * 75, 1e-5, f64_core=True)
    # f64 never loses finiteness relative to f32 (it may not gain it:
    # the f32 STATS can be non-PSD past repair — measured round 5)
    if bool(jnp.isfinite(b32_bad)):
        assert bool(jnp.isfinite(b64_bad))
        np.testing.assert_allclose(float(b64_bad), float(b32_bad),
                                   rtol=5e-2)
    # gradient through the f64 branch on the benign stats stays finite
    g64 = jax.grad(lambda p: sgpr_elbo_from_stats(
        kern, {**p, "Z": Z}, st, 300, 1e-6, f64_core=True))(kp)
    gflat, _ = jax.flatten_util.ravel_pytree(g64)
    assert bool(jnp.all(jnp.isfinite(gflat)))

"""Fixed-parameter kernel/ELBO goldens vs INDEPENDENT evaluations.

The golden-metric suite records its constants on this repo's own f64 path,
so it catches regressions but proves nothing about the math itself. The constants here were computed with mpmath at 30 significant
digits straight from the textbook formulas the reference's gpytorch stack
implements (reference kernel structure: models/sgpr.py:35-37 and the CO2
composite experiments/co2_baseline.py:89-98) — none of them ever touched
ggp_tpu code. The ELBO golden re-derives the collapsed Titsias bound in
plain numpy f64 with explicit-difference grams (no sq_dist trick, no
tri_solve; ggp_tpu.utils.np_reference), so a drift in kernels/base.py,
kernels/composite.py, or models/sgpr.py semantics fails these tests even if
the repo's own paths drift together.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ggp_tpu.kernels import co2_kernel
from ggp_tpu.kernels.base import (
    RBF, Cosine, Matern12, Matern32, Matern52, Periodic, RationalQuadratic,
)

# ---------------------------------------------------------------------------
# scalar-entry goldens (mpmath, 30 dps), 1-D x=0.3, z=1.7, log_ls=0.25
# (RQ: log_alpha=-0.3; Periodic: fixed p=1 and learnable log_p=0.4;
#  Cosine: log_p=0.1)
# ---------------------------------------------------------------------------

_X, _Z, _LOG_LS = 0.3, 1.7, 0.25

ENTRY_GOLDENS = [
    (RBF(ard=False), {"log_lengthscale": _LOG_LS}, 0.5518935770352754),
    (Matern12(ard=False), {"log_lengthscale": _LOG_LS},
     0.33610855316519796),
    (Matern32(ard=False), {"log_lengthscale": _LOG_LS}, 0.4370283859518777),
    (Matern52(ard=False), {"log_lengthscale": _LOG_LS},
     0.47328698908223939),
    (RationalQuadratic(ard=False),
     {"log_lengthscale": _LOG_LS, "log_alpha": -0.3}, 0.64635128208864888),
    (Periodic(fixed_period=1.0), {"log_lengthscale": _LOG_LS},
     0.33379632712694517),
    (Periodic(), {"log_lengthscale": _LOG_LS, "log_period": 0.4},
     0.95619185184512128),
    (Cosine(), {"log_period": 0.1}, -0.1051890507823226),
]


@pytest.mark.parametrize("kern,params,golden", ENTRY_GOLDENS,
                         ids=[type(k).__name__ + str(i)
                              for i, (k, _, _) in enumerate(ENTRY_GOLDENS)])
def test_stationary_entry_goldens(kern, params, golden):
    p = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    x1 = jnp.asarray([[_X]], jnp.float64)
    x2 = jnp.asarray([[_Z]], jnp.float64)
    val = float(kern.gram(p, x1, x2)[0, 0])
    np.testing.assert_allclose(val, golden, rtol=1e-12)
    # diag is exactly 1 for all stationary/periodic unit-variance bases
    np.testing.assert_allclose(np.asarray(kern.diag(p, x1)), 1.0, rtol=1e-12)


def test_rbf_ard_entry_golden():
    """D=3 ARD entry: per-dimension lengthscales enter as exp(log_ls_d)."""
    kern = RBF(ard=True)
    p = {"log_lengthscale": jnp.asarray([0.1, -0.2, 0.3], jnp.float64)}
    x1 = jnp.asarray([[0.3, -1.2, 0.5]], jnp.float64)
    x2 = jnp.asarray([[1.0, 0.4, -0.2]], jnp.float64)
    np.testing.assert_allclose(float(kern.gram(p, x1, x2)[0, 0]),
                               0.10597166856031906, rtol=1e-12)


# ---------------------------------------------------------------------------
# CO2 composite gram goldens (reference experiments/co2_baseline.py:89-98:
# Scale(Periodic(p=1 frozen) * RBF) + Scale(RBF) + Scale(RQ) + Scale(noise))
# ---------------------------------------------------------------------------

def _co2_param_tree(noise: str):
    """Deliberately non-trivial fixed values for every leaf."""
    f64 = jnp.float64
    seasonal = {"log_outputscale": jnp.asarray(0.2, f64),
                "base": {"terms": (
                    {"log_lengthscale": jnp.asarray(0.3, f64)},
                    {"log_lengthscale": jnp.asarray(-0.1, f64)})}}
    trend = {"log_outputscale": jnp.asarray(0.5, f64),
             "base": {"log_lengthscale": jnp.asarray(1.2, f64)}}
    medium = {"log_outputscale": jnp.asarray(-0.4, f64),
              "base": {"log_lengthscale": jnp.asarray(0.6, f64),
                       "log_alpha": jnp.asarray(0.15, f64)}}
    nz = {"log_outputscale": jnp.asarray(-1.0, f64),
          "base": {"log_lengthscale": jnp.asarray(-0.7, f64)}}
    del noise  # same tree for both variants (Matern32 shares RBF's leaves)
    return {"terms": (seasonal, trend, medium, nz)}


_CO2_X1 = [0.25, 1.4, 3.1]
_CO2_X2 = [0.6, 2.25]
CO2_GRAM_GOLDEN = {
    "rbf": [[3.0588793995300429, 1.8940087755402796],
            [2.8785676126608247, 2.9112750791971728],
            [1.5871052626925959, 2.9112750791971728]],
    "matern32": [[3.012920218557244, 1.8966392812845597],
                 [2.8636903397192067, 2.9014844632464961],
                 [1.5876880915034394, 2.9014844632464961]],
}


@pytest.mark.parametrize("noise", ["rbf", "matern32"])
def test_co2_composite_gram_golden(noise):
    kern = co2_kernel(noise_component=noise)
    params = _co2_param_tree(noise)
    x1 = jnp.asarray(_CO2_X1, jnp.float64)[:, None]
    x2 = jnp.asarray(_CO2_X2, jnp.float64)[:, None]
    G = np.asarray(kern.gram(params, x1, x2))
    np.testing.assert_allclose(G, CO2_GRAM_GOLDEN[noise], rtol=1e-12)
    # composite diag at fixed params: sum of the four outputscales
    diag_expected = sum(math.exp(v) for v in (0.2, 0.5, -0.4, -1.0))
    np.testing.assert_allclose(np.asarray(kern.diag(params, x1)),
                               diag_expected, rtol=1e-12)


# ---------------------------------------------------------------------------
# SGPR ELBO golden: collapsed Titsias bound re-derived in plain numpy f64
# (ggp_tpu.utils.np_reference: explicit-difference grams, np.linalg) —
# independent of sq_dist / tri_solve / safe_cholesky / _bound_core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["co2", "rbf_ard"])
def test_co2_sgpr_elbo_vs_independent_numpy(kernel):
    from ggp_tpu.kernels import default_rbf
    from ggp_tpu.models.sgpr import sgpr_elbo, sgpr_elbo_fast
    from ggp_tpu.utils import np_reference as ref

    rs = np.random.RandomState(7)
    log_noise = -1.6
    jitter = 1e-10
    if kernel == "co2":
        X = np.sort(rs.uniform(0.0, 5.0, 24))[:, None]
        y = np.sin(2.0 * np.pi * X[:, 0]) + 0.6 * X[:, 0] \
            + 0.1 * rs.randn(24)
        Z = np.linspace(0.2, 4.8, 6)[:, None]
        kern = co2_kernel("rbf")
        kp = _co2_param_tree("rbf")
        Kmm, Kmn = ref.co2_gram(Z, Z, kp), ref.co2_gram(Z, X, kp)
        kdiag = np.full(len(X), ref.co2_gram([0.0], [0.0], kp)[0, 0])
    else:
        X = rs.randn(30, 3)
        y = np.sin(X.sum(1)) + 0.1 * rs.randn(30)
        Z = rs.randn(7, 3)
        kern = default_rbf(ard=True)
        kp = {"log_outputscale": jnp.asarray(0.3, jnp.float64),
              "base": {"log_lengthscale": jnp.asarray([0.1, -0.2, 0.4],
                                                      jnp.float64)}}
        Kmm = ref.rbf_ard(Z, Z, [0.1, -0.2, 0.4], 0.3)
        Kmn = ref.rbf_ard(Z, X, [0.1, -0.2, 0.4], 0.3)
        kdiag = np.full(len(X), math.exp(0.3))

    golden = ref.titsias_bound(Kmm, Kmn, kdiag, y, log_noise, jitter)

    params = {"kernel": kp,
              "Z": jnp.asarray(Z, jnp.float64),
              "log_noise": jnp.asarray(log_noise, jnp.float64)}
    Xj = jnp.asarray(X, jnp.float64)
    yj = jnp.asarray(y, jnp.float64)
    val = float(sgpr_elbo(kern, params, Xj, yj, jitter=jitter))
    np.testing.assert_allclose(val, golden, rtol=1e-9)
    # the linalg-call-minimised variant agrees up to fp reassociation
    val_fast = float(sgpr_elbo_fast(kern, params, Xj, yj, jitter=jitter))
    np.testing.assert_allclose(val_fast, golden, rtol=1e-7)

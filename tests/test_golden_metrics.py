"""Golden-metric regression tests (SURVEY §4 implication 3).

Training-based metrics are chaotic on this barely-identifiable synthetic
problem (any fp perturbation shifts the Adam trajectory by ~10%), so the
hard goldens are *fixed-parameter* quantities — exact to fp noise — plus one
wide-band end-to-end training sanity. The real UCI rows
(benchmarks_nlpd_main.csv) need downloaded data; see DATA.md.
"""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "experiments"))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ggp_tpu.kernels import default_rbf
from ggp_tpu.models.gpr_hmc import gp_marginal_loglik
from ggp_tpu.models.sgpr import sgpr_elbo, sgpr_predict
from ggp_tpu.utils.datasets import get_regression_data
from ggp_tpu.utils.metrics import nlpd, rmse

# recorded on the f64 CPU path (Boston-shaped synthetic-small, split 0,
# M=100 @ seed 45, fixed hypers os=e^0.3, ls=e^0.5, noise=e^-1.5)
GOLDEN = {"elbo": -1306.255272, "lml": -469.377496,
          "rmse": 1.97094345, "nlpd": 2.12805763}


@pytest.fixture(scope="module")
def fixed_setup():
    d = get_regression_data("synthetic-small", split=0, prop=0.8)
    X = jnp.asarray(d.X_train); y = jnp.asarray(d.Y_train)
    Xt = jnp.asarray(d.X_test); yt = jnp.asarray(d.Y_test)
    kern = default_rbf(ard=True)
    rngs = np.random.RandomState(45)
    Z = X[rngs.randint(0, X.shape[0], 100)]
    p = {"kernel": {"log_outputscale": jnp.asarray(0.3),
                    "base": {"log_lengthscale": jnp.full(13, 0.5)}},
         "log_noise": jnp.asarray(-1.5), "Z": Z}
    return d, X, y, Xt, yt, kern, p


def test_golden_elbo(fixed_setup):
    d, X, y, Xt, yt, kern, p = fixed_setup
    elbo = float(sgpr_elbo(kern, p, X, y, 1e-8))
    np.testing.assert_allclose(elbo, GOLDEN["elbo"], rtol=1e-6)


def test_golden_lml(fixed_setup):
    d, X, y, Xt, yt, kern, p = fixed_setup
    lml = float(gp_marginal_loglik(
        kern, {"kernel": p["kernel"], "log_noise": p["log_noise"]}, X, y, 1e-8))
    np.testing.assert_allclose(lml, GOLDEN["lml"], rtol=1e-6)


def test_golden_predictive(fixed_setup):
    d, X, y, Xt, yt, kern, p = fixed_setup
    mean, var = sgpr_predict(kern, p, X, y, Xt, 1e-8, full_cov=False)
    np.testing.assert_allclose(float(rmse(mean, yt, d.Y_std)),
                               GOLDEN["rmse"], rtol=1e-6)
    np.testing.assert_allclose(float(nlpd(mean, var, yt, d.Y_std)),
                               GOLDEN["nlpd"], rtol=1e-6)


def test_training_sanity_band(tmp_path, monkeypatch):
    """Wide-band end-to-end check: trained SGPR on this problem lands in
    [1.6, 2.6] RMSE / [1.9, 2.5] NLPD across environments."""
    import ggp_tpu.utils.experiment_tools as et
    monkeypatch.setattr(et, "LOG_DIR", str(tmp_path))
    from regression import single_run
    r = single_run("synthetic-small", 0, "SGPR", max_iters=500, verbose=False)
    assert 1.6 < r["test_rmse"] < 2.6, r
    assert 1.9 < r["test_nlpd"] < 2.5, r

"""The XLA trainers at the shapes the removed whole-loop kernels used to
serve (N > 2048 rows, M = 512 inducing points): finite, falling losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

N, M, D = 2100, 512, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N, D))
    y = np.sin(X @ np.array([1.0, -0.5, 0.3])) + 0.1 * rng.normal(size=N)
    return jnp.asarray(X), jnp.asarray(y), jnp.asarray(X[:M] + 0.01)


def _sgpr(X, y, Z):
    from ggp_tpu.models import SparseGPR
    return SparseGPR(X, y, Z_init=Z).train_model(max_steps=6, lr=0.02,
                                                 verbose=False)


def _svgp(X, y, Z):
    from ggp_tpu.models import StochasticVariationalGP
    m = StochasticVariationalGP(X, y, Z_init=Z)
    return m.train_model(num_epochs=2, batch_size=1024, lr=0.02)


def _svgp_probit(X, y, Z):
    from ggp_tpu.likelihoods import BernoulliProbit
    from ggp_tpu.models import StochasticVariationalGP
    m = StochasticVariationalGP(X, (y > 0).astype(X.dtype), Z_init=Z,
                                likelihood=BernoulliProbit())
    return m.train_model(num_epochs=2, batch_size=1024, lr=0.02)


def _bsvgp(X, y, Z):
    from ggp_tpu.models import BayesianStochasticVariationalGP
    m = BayesianStochasticVariationalGP(X, y, Z_init=Z)
    return m.train_model(num_epochs=2, batch_size=1024, lr=0.02)


def _sgpmc_warm(X, y, Z):
    from ggp_tpu.models import SGPMC
    return SGPMC(X, y, Z_init=Z).warm_start(num_steps=6, lr=0.02)


def _flagship_warm_and_zopt(X, y, Z):
    from ggp_tpu.models import BayesianSparseGPR_HMC
    m = BayesianSparseGPR_HMC(X, y, Z_init=Z)
    warm = np.asarray(m.warm_start(num_steps=5, lr=0.02))
    # a two-sample hyper trace around the warm-start point
    m.trace = jax.tree_util.tree_map(
        lambda a: jnp.stack([a, a + 0.05]), m.hypers)
    zl = np.asarray(m.optimize_Z(num_steps=4, lr=0.02))
    assert np.isfinite(zl).all() and zl[-1] < zl[0]
    return warm


TRAINERS = {"sgpr": _sgpr, "svgp_gaussian": _svgp,
            "svgp_probit": _svgp_probit, "bayesian_svgp": _bsvgp,
            "sgpmc_warm_start": _sgpmc_warm,
            "flagship_warm_start_optimize_z": _flagship_warm_and_zopt}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_loss_finite_and_falling(data, name):
    losses = np.asarray(TRAINERS[name](*data), np.float64)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (losses[0], losses[-1])

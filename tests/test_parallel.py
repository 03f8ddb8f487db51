"""Sharding tests on the 8-device virtual CPU mesh (SURVEY §4 implication 5).

Checks the load-bearing property: sharded values AND gradients match the
single-device reference implementation exactly.
"""

import numpy as np
import jax
import jax.flatten_util
import jax.numpy as jnp
import pytest

from ggp_tpu.kernels import default_rbf
from ggp_tpu.models.sgpr import sgpr_elbo, sgpr_elbo_from_stats, vfe_stats
from ggp_tpu.parallel import (
    make_mesh, make_sharded_train_step, make_sharded_value_and_grad,
    sharded_elbo,
)
from ggp_tpu.priors import log_prior, prior_tree_rbf
from ggp_tpu.utils.load_data import DataConfig, load_1d_synthetic


@pytest.fixture(scope="module")
def setup():
    X, y, _ = load_1d_synthetic(data_cfg=DataConfig(n=64, noise=0.2), seed=9)
    kern = default_rbf(ard=True)
    params = {"kernel": kern.init_params(1),
              "log_noise": jnp.log(jnp.asarray(0.05)),
              "Z": X[::8] + 0.01}
    return kern, params, X, y


def test_mesh_shapes():
    m = make_mesh(8)
    assert set(m.axis_names) == {"chains", "data"}
    assert m.devices.size == 8
    m2 = make_mesh(4)
    assert m2.devices.size == 4


def test_stats_elbo_equals_direct(setup):
    kern, params, X, y = setup
    direct = sgpr_elbo(kern, params, X, y, 1e-10)
    stats = vfe_stats(kern, params["kernel"], params["Z"], X, y)
    via_stats = sgpr_elbo_from_stats(kern, params, stats, X.shape[0], 1e-10)
    np.testing.assert_allclose(float(direct), float(via_stats), rtol=1e-8)


def test_sharded_elbo_matches(setup):
    kern, params, X, y = setup
    mesh = make_mesh(8)
    val = sharded_elbo(kern, mesh, params, X, y, 1e-10)
    direct = sgpr_elbo(kern, params, X, y, 1e-10)
    np.testing.assert_allclose(float(val), float(direct), rtol=1e-8)


def test_sharded_grad_matches(setup):
    """The hand-decomposed sharded gradient (direct + psum'd stats path)
    must equal jax.grad of the dense bound."""
    kern, params, X, y = setup
    mesh = make_mesh(8)
    prior = prior_tree_rbf()
    n = X.shape[0]
    vg = make_sharded_value_and_grad(kern, prior, mesh, n, 1e-10)
    val, g = jax.jit(vg)(params, X, y)

    def ref(p):
        lp = sgpr_elbo(kern, p, X, y, 1e-10)
        lp += log_prior(prior, {k: p[k] for k in ("kernel", "log_noise")})
        return -lp

    rval, rg = jax.value_and_grad(ref)(params)
    np.testing.assert_allclose(float(val), float(rval), rtol=1e-8)
    for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(rg)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


def test_sharded_train_step_runs_and_moves(setup):
    kern, params, X, y = setup
    mesh = make_mesh(8)
    prior = prior_tree_rbf()
    hypers = {k: params[k] for k in ("kernel", "log_noise")}
    flat, unravel = jax.flatten_util.ravel_pytree(hypers)
    n_chains = mesh.shape["chains"] * 2
    zs = jnp.tile(flat[None], (n_chains, 1))
    zs = zs + 0.01 * jax.random.normal(jax.random.PRNGKey(0), zs.shape)
    keys = jax.random.split(jax.random.PRNGKey(1), n_chains)
    step = make_sharded_train_step(kern, prior, mesh, unravel, X.shape[0],
                                   1e-10, step_size=0.01, num_leapfrog=4)
    step = jax.jit(step)
    zs2, Z2, accs = step(zs, keys, params["Z"], X, y)
    zs3, Z3, accs2 = step(zs2, keys, Z2, X, y)
    assert zs2.shape == zs.shape
    assert np.isfinite(np.asarray(zs3)).all()
    assert np.isfinite(np.asarray(accs)).all()
    # Z actually updated
    assert np.abs(np.asarray(Z3) - np.asarray(params["Z"])).max() > 0


def test_chain_sharded_nuts_matches_unsharded():
    """build_sampler(mesh=...) shards chains across devices; results must be
    IDENTICAL to the unsharded run (same program, different partitioning)."""
    import jax.numpy as jnp
    from ggp_tpu.inference import NUTSConfig, build_sampler

    logprob = lambda p, _: -0.5 * jnp.sum(p["x"] ** 2)
    init = {"x": jnp.zeros(3)}
    cfg = NUTSConfig(num_warmup=100, num_samples=50)
    mesh = make_mesh(8, chains_axis=4)
    key = jax.random.PRNGKey(0)

    plain = build_sampler(logprob, init, cfg, num_chains=8)
    shard = build_sampler(logprob, init, cfg, num_chains=8, mesh=mesh)
    s1, _ = plain(init, key, None)
    s2, _ = shard(init, key, None)
    a, b = np.asarray(s1["x"]), np.asarray(s2["x"])
    assert a.shape == b.shape == (8, 50, 3)
    # same program, different partitioning: fp reassociation (~1e-8) gets
    # amplified by the chaotic trajectories, so compare statistically plus
    # a loose elementwise bound
    np.testing.assert_allclose(a, b, atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(a.mean(), b.mean(), atol=1e-3)
    np.testing.assert_allclose(a.std(), b.std(), atol=1e-3)


def test_chain_sharded_model_api():
    """mesh= threads through the model ctor (BayesianSGPR_HMC)."""
    from ggp_tpu.models import BayesianSparseGPR_HMC
    from ggp_tpu.utils.load_data import DataConfig, load_1d_synthetic

    X, y, _ = load_1d_synthetic(data_cfg=DataConfig(n=40, noise=0.2), seed=3)
    mesh = make_mesh(8, chains_axis=4)
    m = BayesianSparseGPR_HMC(X, y, Z_init=X[::5], mesh=mesh)
    m.train_fixed_model(num_warmup=80, num_samples=40, num_chains=4,
                        key=jax.random.PRNGKey(0))
    assert jax.tree_util.tree_leaves(m.trace)[0].shape[0] == 160
    means, vars_ = m.mixture_posterior_predictive(X)
    assert np.isfinite(np.asarray(means)).all()


def test_chain_sharded_placement():
    """Chain-sharded sampler output is actually partitioned across devices
    (not just numerically correct)."""
    import jax.numpy as jnp
    from ggp_tpu.inference import NUTSConfig, build_sampler

    logprob = lambda p, _: -0.5 * jnp.sum(p["x"] ** 2)
    init = {"x": jnp.zeros(2)}
    mesh = make_mesh(8, chains_axis=8)
    sampler = build_sampler(logprob, init, NUTSConfig(50, 20), num_chains=8,
                            mesh=mesh)
    samples, stats = sampler(init, jax.random.PRNGKey(0), None)
    # step_size has shape (chains,) and should be sharded over the mesh
    sharding = stats["step_size"].sharding
    assert len(sharding.device_set) == 8, sharding


@pytest.mark.slow
def test_full_adaptive_trainer_chains_x_data_sharded():
    """VERDICT r1 item 3: the PRODUCTION sampler (windowed warmup adaptation,
    dual averaging, Welford mass, NUTS) runs (chains x data)-sharded via the
    model API and matches the unsharded posterior statistically. The mesh
    shards both the chain ensemble (2-way) and the N training rows (4-way);
    GSPMD inserts the data-axis psums inside every leapfrog."""
    import jax.numpy as jnp
    from ggp_tpu.models import BayesianSparseGPR_HMC

    rng = np.random.default_rng(11)
    N, D, M = 96, 2, 12
    X = jnp.asarray(rng.normal(size=(N, D)))
    y = jnp.sin(X[:, 0]) + 0.5 * X[:, 1] + \
        0.1 * jnp.asarray(rng.normal(size=N))
    Z = X[:M]
    mesh = make_mesh(8, chains_axis=2)
    assert mesh.shape == {"chains": 2, "data": 4}

    def run(mesh_arg):
        m = BayesianSparseGPR_HMC(X, y, Z_init=Z, mesh=mesh_arg)
        m.train_model(max_steps=120, hmc_scheduler=[40, 80],
                      num_chains=2, key=jax.random.PRNGKey(3))
        tr = m.trace
        flat = np.concatenate([np.asarray(v).reshape(v.shape[0], -1)
                               for v in jax.tree_util.tree_leaves(tr)], -1)
        stats = m.stats
        return flat, stats, m

    f_sh, st_sh, m_sh = run(mesh)
    # data actually sharded
    sh = m_sh.train_x.sharding
    assert getattr(sh, "spec", None) is not None
    f_plain, st_plain, _ = run(None)

    assert np.isfinite(f_sh).all() and np.isfinite(f_plain).all()
    acc_sh = float(np.mean(np.asarray(st_sh["accept_prob"])))
    acc_pl = float(np.mean(np.asarray(st_plain["accept_prob"])))
    assert 0.5 < acc_sh <= 1.0 and 0.5 < acc_pl <= 1.0
    # posterior moments agree within sampling error (short chains -> loose)
    m1, m2 = f_sh.mean(0), f_plain.mean(0)
    s1, s2 = f_sh.std(0) + 1e-3, f_plain.std(0) + 1e-3
    assert np.all(np.abs(m1 - m2) / np.sqrt(s1 ** 2 + s2 ** 2) < 4.0), \
        (m1, m2, s1, s2)


def test_distributed_two_process_smoke(tmp_path):
    """Two real processes join via jax.distributed.initialize and agree on
    the global device count — the multi-host code path (SURVEY §5.8) on one
    machine."""
    import os
    import subprocess
    import sys

    script = r'''
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from ggp_tpu.parallel.distributed import initialize_distributed
info = initialize_distributed(coordinator_address="localhost:29571",
                              num_processes=2,
                              process_id=int(sys.argv[1]))
assert info["num_processes"] == 2
assert info["process_id"] == int(sys.argv[1])
print("proc", info["process_id"], "global", info["global_devices"], flush=True)
'''
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))),
                              env={**os.environ,
                                   "JAX_PLATFORMS": "cpu",
                                   "XLA_FLAGS": ""})
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i} global" in out

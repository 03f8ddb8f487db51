"""Sampler correctness: NUTS/HMC recover known targets (SURVEY §4
implication 2 — the reference has no sampler tests at all)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ggp_tpu.inference import NUTSConfig, effective_sample_size, run_nuts, split_rhat


def test_nuts_standard_normal():
    logprob = lambda p: -0.5 * jnp.sum(p["x"] ** 2)
    init = {"x": jnp.zeros(3)}
    samples, stats = run_nuts(logprob, init, jax.random.PRNGKey(0),
                              NUTSConfig(num_warmup=300, num_samples=500),
                              num_chains=2)
    x = np.asarray(samples["x"])          # (2, 500, 3)
    assert x.shape == (2, 500, 3)
    assert np.abs(x.mean()) < 0.1
    assert np.abs(x.std() - 1.0) < 0.1
    assert np.asarray(stats["diverging"]).sum() == 0
    acc = np.asarray(stats["accept_prob"])
    assert 0.6 < acc.mean() < 1.0


def test_nuts_correlated_gaussian():
    """Strongly correlated 2D Gaussian — mass adaptation must cope."""
    cov = jnp.asarray([[1.0, 0.95], [0.95, 1.2]])
    prec = jnp.linalg.inv(cov)
    logprob = lambda p: -0.5 * p["x"] @ prec @ p["x"]
    samples, stats = run_nuts(logprob, {"x": jnp.zeros(2)},
                              jax.random.PRNGKey(1),
                              NUTSConfig(num_warmup=500, num_samples=1000),
                              num_chains=2)
    x = np.asarray(samples["x"]).reshape(-1, 2)
    emp = np.cov(x.T)
    np.testing.assert_allclose(emp, np.asarray(cov), atol=0.25)
    for j in range(2):
        assert split_rhat(np.asarray(samples["x"])[..., j]) < 1.05


def test_nuts_gamma_target():
    """Gamma(3, 2) sampled in log space (the prior-transform pattern used by
    all HMC models). Mean=1.5, var=0.75."""
    a, b = 3.0, 2.0
    def logprob(p):
        u = p["u"]
        x = jnp.exp(u)
        return jnp.sum((a - 1.0) * u - b * x + u)
    samples, _ = run_nuts(logprob, {"u": jnp.zeros(1)}, jax.random.PRNGKey(2),
                          NUTSConfig(num_warmup=400, num_samples=1500),
                          num_chains=2)
    x = np.exp(np.asarray(samples["u"]).ravel())
    assert abs(x.mean() - a / b) < 0.1
    assert abs(x.var() - a / b ** 2) < 0.15


def test_hmc_algorithm_standard_normal():
    logprob = lambda p: -0.5 * jnp.sum(p["x"] ** 2)
    samples, stats = run_nuts(
        logprob, {"x": jnp.zeros(2)}, jax.random.PRNGKey(3),
        NUTSConfig(num_warmup=300, num_samples=800, algorithm="hmc",
                   num_leapfrog=10), num_chains=2)
    x = np.asarray(samples["x"])
    assert np.abs(x.mean()) < 0.12
    assert np.abs(x.std() - 1.0) < 0.12


@pytest.mark.parametrize("num_warmup,windows", [
    (25, []), (99, []), (100, [(15, 90)]),
    (500, [(75, 100), (100, 150), (150, 250), (250, 450)])])
def test_warmup_schedule(num_warmup, windows):
    """Stan's windows, and none when too few steps would follow the last
    window for dual averaging to settle."""
    from ggp_tpu.inference.hmc import warmup_schedule
    in_w, w_end = (np.asarray(a) for a in warmup_schedule(num_warmup))
    assert in_w.shape == w_end.shape == (num_warmup,)
    expect_in = np.zeros(num_warmup, bool)
    expect_end = np.zeros(num_warmup, bool)
    for lo, hi in windows:
        expect_in[lo:hi] = True
        expect_end[hi - 1] = True
    np.testing.assert_array_equal(in_w, expect_in)
    np.testing.assert_array_equal(w_end, expect_end)


def test_short_warmup_step_size_settles():
    """A 25-step warmup (the alternating trainer's middle rounds) must end
    on a usable step size in every chain, not one left several times too
    large by a dual-averaging restart two steps before the end."""
    logprob = lambda p: -0.5 * jnp.sum((p["x"] / 0.3) ** 2)
    _, stats = run_nuts(logprob, {"x": jnp.zeros(15)}, jax.random.PRNGKey(4),
                        NUTSConfig(num_warmup=25, num_samples=10),
                        num_chains=16)
    acc = np.asarray(stats["accept_prob"]).mean(axis=1)
    assert np.asarray(stats["diverging"]).sum() == 0
    assert acc.min() > 0.5, acc


def test_ess_sanity():
    rng = np.random.default_rng(0)
    iid = rng.normal(size=(2, 1000))
    ess_iid = effective_sample_size(iid)
    assert ess_iid > 1200        # ~2000 for iid
    # AR(1) with rho=0.9 -> tau ~ 19
    ar = np.zeros((2, 2000))
    for c in range(2):
        for t in range(1, 2000):
            ar[c, t] = 0.9 * ar[c, t - 1] + rng.normal()
    ess_ar = effective_sample_size(ar)
    assert ess_ar < 600


def test_rhat_detects_nonconvergence():
    rng = np.random.default_rng(1)
    good = rng.normal(size=(4, 500))
    bad = good + np.arange(4)[:, None] * 3.0
    assert split_rhat(good) < 1.01
    assert split_rhat(bad) > 1.5


@pytest.mark.slow
def test_chunked_sampler_matches_statistics():
    """build_sampler_chunked: bounded-length program invocations; posterior
    statistics must match the monolithic sampler on a known target."""
    from ggp_tpu.inference.hmc import build_sampler, build_sampler_chunked

    logprob = lambda p, _: -0.5 * jnp.sum(p["x"] ** 2)
    init = {"x": jnp.zeros(3)}
    cfg = NUTSConfig(num_warmup=250, num_samples=300)
    mono = build_sampler(logprob, init, cfg, num_chains=2)
    chunk = build_sampler_chunked(logprob, init, cfg, num_chains=2,
                                  chunk_size=64)
    s1, st1 = mono(init, jax.random.PRNGKey(0), None)
    progress_calls = []
    s2, st2 = chunk(init, jax.random.PRNGKey(0), None,
                    progress=lambda *a: progress_calls.append(a))
    a, b = np.asarray(s1["x"]), np.asarray(s2["x"])
    assert b.shape == (2, 300, 3)
    assert abs(a.mean() - b.mean()) < 0.1
    assert abs(a.std() - b.std()) < 0.1
    assert np.asarray(st2["diverging"]).sum() == 0
    # progress callback fired for each chunk (warmup rounds to 256 = 4x64)
    assert len(progress_calls) == 4 + 5
    assert progress_calls[0][0] == "warmup" and progress_calls[-1][0] == "sample"


def test_chunked_sampler_checkpoint_resume(tmp_path):
    """Kill-and-resume: a run interrupted mid-warmup resumes from the last
    chunk checkpoint and produces a healthy posterior."""
    from ggp_tpu.inference.hmc import build_sampler_chunked
    from ggp_tpu.utils.checkpoint import CheckpointManager

    logprob = lambda p, _: -0.5 * jnp.sum(p["x"] ** 2)
    init = {"x": jnp.zeros(2)}
    cfg = NUTSConfig(num_warmup=128, num_samples=128)
    sampler = build_sampler_chunked(logprob, init, cfg, num_chains=2,
                                    chunk_size=64)

    class Killed(Exception):
        pass

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)

    def killer(phase, done, total):
        if phase == "warmup" and done >= 128:
            raise Killed()           # die right after warmup chunk 2

    with pytest.raises(Killed):
        sampler(init, jax.random.PRNGKey(0), None, progress=killer,
                ckpt_manager=mgr)
    assert mgr.latest_step() == 2

    # resume: skips the 2 completed warmup chunks, finishes the run
    phases = []
    s2, st2 = sampler(init, jax.random.PRNGKey(0), None,
                      progress=lambda *a: phases.append(a[0]),
                      ckpt_manager=mgr)
    assert phases == ["sample", "sample"]      # warmup fully skipped
    x = np.asarray(s2["x"])
    assert x.shape == (2, 128, 2)
    assert abs(x.std() - 1.0) < 0.15
    assert np.asarray(st2["diverging"]).sum() == 0

    # resuming again still returns the FULL set of draws (sampling reruns
    # from the post-warmup carry; only warmup is skipped)
    s3, _ = sampler(init, jax.random.PRNGKey(0), None, ckpt_manager=mgr)
    assert np.asarray(s3["x"]).shape == (2, 128, 2)

    # a checkpoint from a different configuration is rejected
    sampler2 = build_sampler_chunked(logprob, init, cfg, num_chains=2,
                                     chunk_size=32)
    with pytest.raises(ValueError, match="different sampler configuration"):
        sampler2(init, jax.random.PRNGKey(0), None, ckpt_manager=mgr)

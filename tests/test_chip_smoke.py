"""chip_smoke.py on the CPU: it must refuse to run, and the pieces it is
built from (parity helper, phase lines, result line, mesh checks) work."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("args", [[], ["--gpus", "4"]])
def test_refuses_without_gpu(args):
    out = _run(args, ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run([], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_result_line_shape():
    line = chip_smoke.result_line(jax.devices()[:1])
    obj = json.loads(line)
    assert list(obj) == ["ok", "device"] and obj["ok"] is True
    assert set(obj["device"]) == {"platform", "kind", "count"}
    assert obj["device"]["platform"] == jax.devices()[0].platform
    assert obj["device"]["count"] == 1
    assert "\n" not in line


def test_run_phase_prints_compile_and_run_seconds(capsys):
    jax.monitoring.register_event_duration_secs_listener(chip_smoke._on_event)
    h = chip_smoke.run_phase(
        "probe", lambda: {"value": float(jax.jit(lambda x: x * 3.0)(
            jnp.arange(7.0)).sum())})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "probe" and line["value"] == h["value"] == 63.0
    assert line["compile_s"] > 0.0 and line["run_s"] >= 0.0


def test_failed_check_raises():
    with pytest.raises(chip_smoke.SmokeFailure, match="unhealthy"):
        chip_smoke.check(False, "unhealthy")
    chip_smoke.check(True, "never raised")


def _tiny_problem(seed=0, n=48, d=3, m=8):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.normal(size=(n, d)))
    y = jnp.asarray(np.sin(np.asarray(X).sum(1)) + 0.1 * rng.normal(size=n))
    Z = X[:m] + 0.05
    hypers = {"kernel": {"base": {"log_lengthscale":
                                  jnp.asarray(rng.normal(size=d) * 0.3)},
                         "log_outputscale": jnp.asarray(0.2)},
              "log_noise": jnp.asarray(-1.5)}
    return X, y, Z, hypers


@pytest.mark.parametrize("precision", [None, "default"])
def test_parity_helper_matches_in_float64(precision):
    from ggp_tpu.priors import prior_tree_rbf
    X, y, Z, hypers = _tiny_problem()
    verr, gerr = chip_smoke.potential_parity(X, y, Z, hypers,
                                             prior_tree_rbf(), 1e-8,
                                             precision=precision)
    assert verr < 1e-12 and gerr < 1e-7


def test_parity_helper_catches_a_wrong_prior():
    """The helper compares against the reference's own prior: handing the
    JAX side a different tree than the numbers were derived for must show
    as an O(1) error, far past the smoke tolerances."""
    from ggp_tpu.priors import Gamma, prior_tree_rbf
    X, y, Z, hypers = _tiny_problem(seed=1)
    wrong = prior_tree_rbf()
    wrong["kernel"]["base"]["log_lengthscale"] = Gamma(5.0, 0.1)
    import ggp_tpu.utils.np_reference as ref
    verr_ok, _ = chip_smoke.potential_parity(X, y, Z, hypers, wrong, 1e-8)
    assert verr_ok < 1e-12          # both sides agree on the same tree
    u_right = ref.sgpr_neg_logpost(X, y, Z, hypers, 1e-8, prior_tree_rbf())
    u_wrong = ref.sgpr_neg_logpost(X, y, Z, hypers, 1e-8, wrong)
    assert abs(u_right - u_wrong) / abs(u_right) > chip_smoke.VALUE_RTOL


def test_mesh_checks_on_four_virtual_devices():
    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.normal(size=(64, 2)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(X).sum(1)) + 0.1 * rng.normal(size=64),
                    jnp.float32)
    out = chip_smoke.mesh_checks(4, X, y, X[:8], num_chains=8, tune=40,
                                 draws=30)
    assert out["chains_x_data_mesh"] == {"chains": 2, "data": 2}
    assert out["chains_only_mesh"] == {"chains": 4, "data": 1}
    assert out["chains_x_data_moment_gap_sd"] < 0.75
    assert out["sharded_vg_value_err"] <= 2e-5

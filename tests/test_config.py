"""The compile-cache rule, the package import, and the sweep default."""

import inspect
import os
import subprocess
import sys

import pytest

from ggp_tpu.config import _CHECKOUT, compile_cache_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_env_var_set_means_nothing_is_set():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
    assert compile_cache_dir(env, platforms="") is None
    assert compile_cache_dir(env, platforms="cuda") is None


@pytest.mark.parametrize("platforms", ["", "cuda", "gpu,cpu"])
def test_cache_default_is_the_fixed_checkout_path(platforms):
    path = compile_cache_dir({}, platforms=platforms)
    assert path == os.path.join(_CHECKOUT, ".jax_cache")
    # same answer in every process: no pid, time or temp name in the path
    assert path == compile_cache_dir({}, platforms=platforms)
    assert os.path.realpath(_CHECKOUT) == os.path.realpath(ROOT)


@pytest.mark.parametrize("platforms", ["cpu", "cpu,cpu"])
def test_cache_cpu_only_sets_nothing(platforms):
    assert compile_cache_dir({}, platforms=platforms) is None


@pytest.mark.parametrize("env_var", [False, True])
def test_import_applies_the_rule(tmp_path, env_var):
    """Importing the package with a GPU platform list (no backend is
    started) sets the checkout cache only when the caller set none."""
    code = ("import jax, ggp_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cuda"
    if env_var:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = str(tmp_path) if env_var else os.path.join(_CHECKOUT, ".jax_cache")
    assert out.stdout.strip() == want


def test_import_loads_no_pallas():
    """Neither Pallas nor the optional pandas/matplotlib load on the model
    path or with chip_smoke.py."""
    code = ("import sys, ggp_tpu, ggp_tpu.models, ggp_tpu.inference, "
            "ggp_tpu.parallel, ggp_tpu.ops, ggp_tpu.utils.datasets, "
            "ggp_tpu.inference.sghmc, chip_smoke, bench; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pandas', 'matplotlib') or 'pallas' in m))")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sweep_defaults_to_one_job():
    from ggp_tpu.runtime.sweep import run_sweep
    assert inspect.signature(run_sweep).parameters["jobs"].default == 1

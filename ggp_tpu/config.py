"""Global configuration for ggp_tpu.

Rethink of the reference's ``utils/config.py`` (reference:
utils/config.py:8-19): instead of torch/GPU discovery we carry a dtype
policy (f64 when x64 is enabled, f32 otherwise), a single jitter policy (the
reference scatters 1e-6/1e-5/1e-4 across files, e.g.
experiments/regression.py:34, models/bayesian_sgpr_hmc.py:226), and the
canonical split seed ``BASE_SEED=173`` (reference: utils/config.py:14,
used by utils/dataset.py:62).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=os.environ, platforms=None):
    """Where this package puts JAX's persistent compilation cache, or None
    to set nothing.

    NUTS/while-loop programs take seconds to compile, so a process restart
    should find them again. A ``JAX_COMPILATION_CACHE_DIR`` set by the
    caller is JAX's own setting and wins: nothing is set here then.
    Otherwise the cache lives at the fixed path ``<checkout>/.jax_cache``
    (the path is part of what makes a later process hit). CPU-only
    processes keep no cache: XLA:CPU entries are specific to the host's CPU
    features.
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if platforms is None:
        platforms = jax.config.jax_platforms or ""
    if platforms and set(platforms.split(",")) <= {"cpu"}:
        return None
    return os.path.join(_CHECKOUT, ".jax_cache")


def _enable_compile_cache():
    cache_dir = compile_cache_dir()
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()

# Reference parity constants -------------------------------------------------
EPSILON = 1e-6           # reference: utils/config.py:13
BASE_SEED = 173          # reference: utils/config.py:14 (train/test split shuffling)

# Path roots (reference: utils/config.py:16-19) ------------------------------
BASE_PATH = os.environ.get("GGP_BASE_PATH", _CHECKOUT)
RESULTS_DIR = os.path.join(BASE_PATH, "results")
DATASET_DIR = os.environ.get("GGP_DATASET_DIR", os.path.join(BASE_PATH, "data"))
LOG_DIR = os.path.join(BASE_PATH, "logs")


def default_dtype() -> jnp.dtype:
    """f64 when x64 is enabled (CPU parity tests), else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def default_jitter(dtype=None) -> float:
    """Diagonal jitter added before every Cholesky.

    f64 keeps the reference's 1e-6 scale; f32 needs more headroom
    (the reference itself escalates to 1e-4 for ill-conditioned mixture
    covariances, models/bayesian_sgpr_hmc.py:226).
    """
    dtype = dtype or default_dtype()
    return 1e-8 if jnp.dtype(dtype) == jnp.float64 else 1e-5

"""ggp_tpu — Generalised (fully-Bayesian) Gaussian Processes in JAX.

From-scratch JAX/XLA rebuild of vr308/Generalised-Gaussian-Processes:
sparse GP regression and classification with distributions over kernel
hyperparameters, inferred by jitted HMC/NUTS (vmapped parallel chains) or
variational inference — one compiled program end-to-end instead of the
reference's GPyTorch/pymc3/gpflow three-backend sprawl.
"""

import jax as _jax

# GP linear algebra is Cholesky-bound. Left at its default precision, a GPU
# may run float32 matmuls in TF32 (10-bit mantissa), which puts ~1e-3
# relative error into Gram matrices: more than any reasonable jitter, so the
# Cholesky of Kmm or B = I + A A^T loses PSD-ness. Force full float32.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import config, kernels, likelihoods, means, priors
from .likelihoods import BernoulliProbit, GaussianLikelihood, PoissonLogCox, Softmax
from .means import Constant, Linear, Zero

__version__ = "0.1.0"

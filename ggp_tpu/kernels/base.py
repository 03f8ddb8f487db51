"""Functional covariance kernels.

Replacement for the gpytorch kernel stack the reference leans on
(reference: models/sgpr.py:35-37 builds ScaleKernel(RBFKernel(ard)), and the
CO2 composite at experiments/co2_baseline.py:89-98 sums four scaled
components). Design differs deliberately from gpytorch's stateful modules:

* a ``Kernel`` is an immutable, hashable *static* description (safe as a jit
  static argument),
* its parameters live in a separate nested-dict pytree of **unconstrained**
  (log-space) leaves, so Adam and HMC both operate directly on the pytree and
  positivity is enforced by ``exp`` inside the kernel maths (the reference's
  pymc3 side samples in log space the same way,
  experiments/co2_bayesian_sgpr_hmc.py:107-144),
* Gram construction is expressed with matmul-dominant ops (the x^2+z^2-2xz
  trick) so XLA maps the cross term onto one matrix product.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "Kernel",
    "RBF",
    "Matern12",
    "Matern32",
    "Matern52",
    "RationalQuadratic",
    "Periodic",
    "Cosine",
    "Linear",
    "Constant",
    "White",
    "Scale",
    "Sum",
    "Product",
]


def _softplus(x):
    return jax.nn.softplus(x)


def sq_dist(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Pairwise squared Euclidean distances via one matmul.

    ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b, clamped at 0 against f32
    cancellation.
    """
    n1 = jnp.sum(x1 * x1, axis=-1, keepdims=True)          # (N1, 1)
    n2 = jnp.sum(x2 * x2, axis=-1, keepdims=True).T        # (1, N2)
    cross = x1 @ x2.T
    return jnp.maximum(n1 + n2 - 2.0 * cross, 0.0)


def dist(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Pairwise Euclidean distance with a grad-safe sqrt at 0."""
    d2 = sq_dist(x1, x2)
    safe = jnp.where(d2 > 0.0, d2, 1.0)
    return jnp.where(d2 > 0.0, jnp.sqrt(safe), 0.0)


@dataclasses.dataclass(frozen=True)
class Kernel:
    """Base class: immutable static structure; params are a separate pytree."""

    def init_params(self, input_dim: int) -> dict:
        raise NotImplementedError

    def gram(self, params: dict, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def diag(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    # -- combinator sugar ----------------------------------------------------
    def __add__(self, other: "Kernel") -> "Sum":
        return Sum((self, other))

    def __mul__(self, other: "Kernel") -> "Product":
        return Product((self, other))

    def scaled(self, log_outputscale: float = 0.0) -> "Scale":
        return Scale(self, init_log_outputscale=log_outputscale)


@dataclasses.dataclass(frozen=True)
class _Stationary(Kernel):
    """Shared lengthscale handling for stationary kernels.

    ``ard`` => one lengthscale per input dim (reference enables ARD via
    ``ard_num_dims`` at models/sgpr.py:36).
    """

    ard: bool = True

    def init_params(self, input_dim: int) -> dict:
        shape = (input_dim,) if self.ard else ()
        return {"log_lengthscale": jnp.zeros(shape)}

    def _scale_inputs(self, params, x):
        ls = jnp.exp(params["log_lengthscale"])
        return x / ls

    def _r2(self, params, x1, x2):
        return sq_dist(self._scale_inputs(params, x1), self._scale_inputs(params, x2))

    def _r(self, params, x1, x2):
        return dist(self._scale_inputs(params, x1), self._scale_inputs(params, x2))


@dataclasses.dataclass(frozen=True)
class RBF(_Stationary):
    """k(x,z) = exp(-0.5 ||(x-z)/l||^2)  (reference: RBFKernel, models/sgpr.py:36)."""

    def gram(self, params, x1, x2):
        return jnp.exp(-0.5 * self._r2(params, x1, x2))

    def diag(self, params, x):
        return jnp.ones(x.shape[0], x.dtype)


@dataclasses.dataclass(frozen=True)
class Matern12(_Stationary):
    def gram(self, params, x1, x2):
        return jnp.exp(-self._r(params, x1, x2))

    def diag(self, params, x):
        return jnp.ones(x.shape[0], x.dtype)


@dataclasses.dataclass(frozen=True)
class Matern32(_Stationary):
    """Matern nu=3/2 (reference CO2 noise component uses Matern32 on the
    pymc3 side, experiments/co2_bayesian_sgpr_hmc.py:145)."""

    def gram(self, params, x1, x2):
        r = self._r(params, x1, x2) * jnp.sqrt(jnp.asarray(3.0, x1.dtype))
        return (1.0 + r) * jnp.exp(-r)

    def diag(self, params, x):
        return jnp.ones(x.shape[0], x.dtype)


@dataclasses.dataclass(frozen=True)
class Matern52(_Stationary):
    def gram(self, params, x1, x2):
        r = self._r(params, x1, x2) * jnp.sqrt(jnp.asarray(5.0, x1.dtype))
        return (1.0 + r + r * r / 3.0) * jnp.exp(-r)

    def diag(self, params, x):
        return jnp.ones(x.shape[0], x.dtype)


@dataclasses.dataclass(frozen=True)
class RationalQuadratic(_Stationary):
    """k = (1 + r^2/(2 alpha l^2))^-alpha (reference CO2 medium-term
    component, experiments/co2_baseline.py:91)."""

    def init_params(self, input_dim: int) -> dict:
        p = super().init_params(input_dim)
        p["log_alpha"] = jnp.zeros(())
        return p

    def gram(self, params, x1, x2):
        alpha = jnp.exp(params["log_alpha"])
        r2 = self._r2(params, x1, x2)
        return jnp.power(1.0 + r2 / (2.0 * alpha), -alpha)

    def diag(self, params, x):
        return jnp.ones(x.shape[0], x.dtype)


@dataclasses.dataclass(frozen=True)
class Periodic(Kernel):
    """k = exp(-2 sum_d sin^2(pi (x_d-z_d)/p) / l^2).

    ``fixed_period`` freezes the period out of the trainable pytree — the
    reference pins the CO2 seasonal period to 1 year and disables its grad
    (experiments/co2_baseline.py:93-94).
    """

    fixed_period: Optional[float] = None

    def init_params(self, input_dim: int) -> dict:
        p = {"log_lengthscale": jnp.zeros(())}
        if self.fixed_period is None:
            p["log_period"] = jnp.zeros(())
        return p

    def _period(self, params):
        if self.fixed_period is not None:
            return jnp.asarray(self.fixed_period)
        return jnp.exp(params["log_period"])

    def gram(self, params, x1, x2):
        period = self._period(params)
        ls2 = jnp.exp(2.0 * params["log_lengthscale"])
        diff = x1[:, None, :] - x2[None, :, :]             # (N1, N2, D)
        s = jnp.sin(jnp.pi * diff / period)
        return jnp.exp(-2.0 * jnp.sum(s * s, axis=-1) / ls2)

    def diag(self, params, x):
        return jnp.ones(x.shape[0], x.dtype)


@dataclasses.dataclass(frozen=True)
class Cosine(Kernel):
    """k = cos(2 pi ||x-z|| / p)."""

    def init_params(self, input_dim: int) -> dict:
        return {"log_period": jnp.zeros(())}

    def gram(self, params, x1, x2):
        period = jnp.exp(params["log_period"])
        return jnp.cos(2.0 * jnp.pi * dist(x1, x2) / period)

    def diag(self, params, x):
        return jnp.ones(x.shape[0], x.dtype)


@dataclasses.dataclass(frozen=True)
class Linear(Kernel):
    """k = sigma_v^2 x.z + sigma_b^2 (reference CO2 SGPMC uses a Linear mean
    analogue, experiments/co2_sgpmc.py:61-64)."""

    def init_params(self, input_dim: int) -> dict:
        return {"log_variance": jnp.zeros(()), "log_bias_variance": jnp.zeros(())}

    def gram(self, params, x1, x2):
        v = jnp.exp(params["log_variance"])
        b = jnp.exp(params["log_bias_variance"])
        return v * (x1 @ x2.T) + b

    def diag(self, params, x):
        v = jnp.exp(params["log_variance"])
        b = jnp.exp(params["log_bias_variance"])
        return v * jnp.sum(x * x, axis=-1) + b


@dataclasses.dataclass(frozen=True)
class Constant(Kernel):
    def init_params(self, input_dim: int) -> dict:
        return {"log_constant": jnp.zeros(())}

    def gram(self, params, x1, x2):
        c = jnp.exp(params["log_constant"])
        return jnp.full((x1.shape[0], x2.shape[0]), c, x1.dtype)

    def diag(self, params, x):
        return jnp.full((x.shape[0],), jnp.exp(params["log_constant"]), x.dtype)


@dataclasses.dataclass(frozen=True)
class White(Kernel):
    """White noise: only contributes on exactly matching gram(X, X) calls is
    ill-defined across arbitrary x1/x2; we define gram as 0 (noise belongs in
    the likelihood) and diag as the variance."""

    def init_params(self, input_dim: int) -> dict:
        return {"log_variance": jnp.zeros(())}

    def gram(self, params, x1, x2):
        return jnp.zeros((x1.shape[0], x2.shape[0]), x1.dtype)

    def diag(self, params, x):
        return jnp.full((x.shape[0],), jnp.exp(params["log_variance"]), x.dtype)


@dataclasses.dataclass(frozen=True)
class Scale(Kernel):
    """outputscale * base (reference: ScaleKernel, models/sgpr.py:36)."""

    base: Kernel = None
    init_log_outputscale: float = 0.0

    def init_params(self, input_dim: int) -> dict:
        return {"log_outputscale": jnp.full((), self.init_log_outputscale),
                "base": self.base.init_params(input_dim)}

    def gram(self, params, x1, x2):
        return jnp.exp(params["log_outputscale"]) * self.base.gram(params["base"], x1, x2)

    def diag(self, params, x):
        return jnp.exp(params["log_outputscale"]) * self.base.diag(params["base"], x)


@dataclasses.dataclass(frozen=True)
class _Combo(Kernel):
    terms: Tuple[Kernel, ...] = ()

    def init_params(self, input_dim: int) -> dict:
        return {"terms": tuple(t.init_params(input_dim) for t in self.terms)}


@dataclasses.dataclass(frozen=True)
class Sum(_Combo):
    def gram(self, params, x1, x2):
        out = self.terms[0].gram(params["terms"][0], x1, x2)
        for t, p in zip(self.terms[1:], params["terms"][1:]):
            out = out + t.gram(p, x1, x2)
        return out

    def diag(self, params, x):
        out = self.terms[0].diag(params["terms"][0], x)
        for t, p in zip(self.terms[1:], params["terms"][1:]):
            out = out + t.diag(p, x)
        return out

    def __add__(self, other: Kernel) -> "Sum":
        return Sum(self.terms + (other,))


@dataclasses.dataclass(frozen=True)
class Product(_Combo):
    def gram(self, params, x1, x2):
        out = self.terms[0].gram(params["terms"][0], x1, x2)
        for t, p in zip(self.terms[1:], params["terms"][1:]):
            out = out * t.gram(p, x1, x2)
        return out

    def diag(self, params, x):
        out = self.terms[0].diag(params["terms"][0], x)
        for t, p in zip(self.terms[1:], params["terms"][1:]):
            out = out * t.diag(p, x)
        return out

    def __mul__(self, other: Kernel) -> "Product":
        return Product(self.terms + (other,))

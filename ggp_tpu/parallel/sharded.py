"""Sharded training: chain-parallel HMC over data-parallel VFE statistics.

The multi-device execution path (SURVEY §2.4):
one ``shard_map`` over a (chains, data) mesh in which

* each device row holds a shard of the HMC chain ensemble,
* each device column holds a shard of the N training rows,
* the collapsed-bound sufficient statistics (``vfe_stats``) are computed on
  local rows and ``psum``-reduced over the ``data`` axis.

Gradient correctness note: the collapsed bound is NOT additive over data
shards (the log|B| couples them), so the usual "psum the gradients" recipe is
wrong, and naively differentiating through the psum inside shard_map drops
the other shards' stats contributions. We therefore split the gradient by
hand into (a) the *direct* path through the replicated Kmm/params (computed
identically everywhere, no reduction) and (b) the *stats* path, whose local
VJP is psum-reduced over ``data``. This decomposition is exactly the
structure a fused stats(+VJP) kernel would accelerate.

This is the scaled-out version of ``BayesianSparseGPR_HMC.train_model``'s
inner loop (reference single-process loop: models/bayesian_sgpr_hmc.py:88-158).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..inference.hmc import hmc_kernel
from ..kernels import Kernel
from ..models.sgpr import sgpr_elbo_from_stats, vfe_stats
from ..priors import log_prior

__all__ = ["make_sharded_value_and_grad", "sharded_elbo",
           "make_sharded_train_step"]


def _tree_add(a, b):
    return jax.tree_util.tree_map(jnp.add, a, b)


def _neg_elbo_and_grad_local(kernel: Kernel, prior_tree, num_data, jitter,
                             params, X_local, y_local, axis_name="data"):
    """Correct (value, grad) of -[elbo + logprior] w.r.t. the FULL params
    dict {kernel, log_noise, Z}, from one device's data shard; requires an
    active ``axis_name`` mesh axis for the stats psum."""

    def stats_fn(p):
        return vfe_stats(kernel, p["kernel"], p["Z"], X_local, y_local)

    stats_local, stats_vjp = jax.vjp(stats_fn, params)
    stats = jax.tree_util.tree_map(
        lambda s: jax.lax.psum(s, axis_name), stats_local)

    def f(p, st):
        val = sgpr_elbo_from_stats(kernel, p, st, num_data, jitter)
        if prior_tree is not None:
            val = val + log_prior(
                prior_tree, {k: v for k, v in p.items() if k in prior_tree})
        return -val

    val, f_vjp = jax.vjp(f, params, stats)
    g_direct, g_stats = f_vjp(jnp.ones_like(val))
    (g_stats_path,) = stats_vjp(g_stats)
    g_stats_path = jax.tree_util.tree_map(
        lambda s: jax.lax.psum(s, axis_name), g_stats_path)
    return val, _tree_add(g_direct, g_stats_path)


def sharded_elbo(kernel: Kernel, mesh: Mesh, params: dict, X, y,
                 jitter=None, prior_tree=None):
    """Data-sharded collapsed VFE bound value: N rows split over ``data``,
    one psum of (M x M + M + 2) stats per evaluation."""
    n = X.shape[0]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P("data"), P("data")), out_specs=P(),
             check_vma=False)
    def _elbo(p, X_local, y_local):
        stats_local = vfe_stats(kernel, p["kernel"], p["Z"], X_local, y_local)
        stats = jax.tree_util.tree_map(
            lambda s: jax.lax.psum(s, "data"), stats_local)
        return sgpr_elbo_from_stats(kernel, p, stats, n, jitter)

    return _elbo(params, X, y)


def make_sharded_value_and_grad(kernel: Kernel, prior_tree, mesh: Mesh,
                                num_data: int, jitter=None):
    """Jittable sharded (value, grad) of the negative collapsed bound over
    the full params dict, for use by outer optimisers."""

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P("data"), P("data")), out_specs=(P(), P()),
             check_vma=False)
    def vg(params, X_local, y_local):
        return _neg_elbo_and_grad_local(kernel, prior_tree, num_data, jitter,
                                        params, X_local, y_local)

    return vg


def make_sharded_train_step(kernel: Kernel, prior_tree, mesh: Mesh,
                            unravel: Callable, num_data: int,
                            jitter: float | None = None,
                            step_size: float = 0.02, num_leapfrog: int = 8,
                            z_lr: float = 0.01):
    """One full alternating step, fully sharded:

    (a) one HMC transition per chain on the hyper state (chains sharded over
        the ``chains`` axis; each leapfrog's potential gradient uses the
        corrected psum-over-``data`` stats path),
    (b) one SGD step on Z under the chain-averaged ELBO (pmean over
        ``chains``).

    ``step(zs, keys, Z, X, y) -> (zs', Z', accept_probs)`` where zs/keys have
    leading chains axis (shard P("chains")), X/y have leading N axis (shard
    P("data")), Z replicated.
    """

    @partial(shard_map, mesh=mesh,
             in_specs=(P("chains"), P("chains", None), P(), P("data"),
                       P("data")),
             out_specs=(P("chains"), P(), P("chains")),
             check_vma=False)
    def step(zs_local, keys_local, Z, X_local, y_local):
        dim = zs_local.shape[-1]
        inv_mass = jnp.ones(dim, zs_local.dtype)
        eps = jnp.asarray(step_size, zs_local.dtype)

        def pvg(zvec):
            hypers = unravel(zvec)
            params = {**hypers, "Z": Z}
            val, g = _neg_elbo_and_grad_local(
                kernel, prior_tree, num_data, jitter, params, X_local, y_local)
            gh = {k: g[k] for k in hypers}
            gflat, _ = jax.flatten_util.ravel_pytree(gh)
            return val, gflat

        def one_chain(zvec, key):
            U, g = pvg(zvec)
            z_new, _, _, st = hmc_kernel(pvg, zvec, U, g, key, eps, inv_mass,
                                         num_leapfrog=num_leapfrog)
            return z_new, st["accept_prob"]

        zs_new, accs = jax.vmap(one_chain)(zs_local, keys_local)

        # (b) Z step under the local-chain-averaged bound, then pmean over
        # the chains axis (each chains-row holds different chains).
        def z_grad_one(zvec):
            hypers = unravel(zvec)
            params = {**hypers, "Z": Z}
            _, g = _neg_elbo_and_grad_local(
                kernel, prior_tree, num_data, jitter, params, X_local, y_local)
            return g["Z"]

        gZ = jnp.mean(jax.vmap(z_grad_one)(zs_new), axis=0)
        gZ = jax.lax.pmean(gZ, "chains")
        Z_new = Z - z_lr * gZ
        return zs_new, Z_new, accs

    return step

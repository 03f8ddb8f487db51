"""Jitted HMC / NUTS with windowed warmup adaptation.

Compiled replacement for the reference's samplers: pymc3 NUTS driving the
VFE marginal (models/bayesian_sgpr_hmc.py:74-78), pymc3 NUTS on the dense
marginal (models/gpr_hmc.py:57), and tfp HMC for gpflow SGPMC
(models/sgp_hmc.py:63-83 — the only compiled sampler in the reference, and
the design precedent here). Differences by design:

* NUTS is the *iterative* fixed-max-depth formulation (checkpoint buffers +
  bit-twiddled U-turn checks) so the whole transition is one
  ``lax.while_loop`` — no recursion, no dynamic shapes, everything stays
  on the device under ``jit``.
* Warmup is Stan-style: dual-averaged step size targeting accept=0.8 with
  expanding diagonal-mass windows (Welford), matching pymc3's default
  adaptation quality.
* Everything is written per-chain over flat vectors and ``vmap``s over chains
  (the reference always runs chains=1, models/bayesian_sgpr_hmc.py:78;
  parallel chains are first-class here and shard across devices via
  ``ggp_tpu.parallel``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np

__all__ = ["NUTSConfig", "run_nuts", "build_sampler", "nuts_kernel",
           "hmc_kernel", "warmup_schedule"]

_DIVERGENCE_THRESHOLD = 1000.0


# --------------------------------------------------------------------------
# Leapfrog
# --------------------------------------------------------------------------

class IntegratorState(NamedTuple):
    z: jnp.ndarray      # position
    r: jnp.ndarray      # momentum (forward-time)
    U: jnp.ndarray      # potential at z
    g: jnp.ndarray      # grad U at z


def leapfrog(potential_vg: Callable, s: IntegratorState, eps: jnp.ndarray,
             inv_mass: jnp.ndarray) -> IntegratorState:
    """One velocity-Verlet step; ``eps`` may be negative (time-reversed)."""
    r_half = s.r - 0.5 * eps * s.g
    z_new = s.z + eps * inv_mass * r_half
    U_new, g_new = potential_vg(z_new)
    r_new = r_half - 0.5 * eps * g_new
    return IntegratorState(z_new, r_new, U_new, g_new)


def _kinetic(r, inv_mass):
    return 0.5 * jnp.sum(inv_mass * r * r)


# --------------------------------------------------------------------------
# Iterative NUTS transition
# --------------------------------------------------------------------------

def _popcount(x):
    return jax.lax.population_count(x.astype(jnp.uint32)).astype(jnp.int32)


def _trailing_ones(x):
    xp1 = (x + 1).astype(jnp.uint32)
    low = xp1 & (jnp.uint32(0) - xp1)          # lowest set bit of x+1
    return _popcount(low - jnp.uint32(1))


class _TreeCarry(NamedTuple):
    key: jnp.ndarray
    left: IntegratorState
    right: IntegratorState
    z_prop: jnp.ndarray
    U_prop: jnp.ndarray
    g_prop: jnp.ndarray
    logw: jnp.ndarray          # log total multinomial weight of tree
    depth: jnp.ndarray
    turning: jnp.ndarray
    diverging: jnp.ndarray
    accept_sum: jnp.ndarray
    n_leaves: jnp.ndarray


def nuts_kernel(potential_vg: Callable, z: jnp.ndarray, U_z: jnp.ndarray,
                g_z: jnp.ndarray, key: jnp.ndarray, eps: jnp.ndarray,
                inv_mass: jnp.ndarray, max_depth: int = 8):
    """One multinomial-NUTS transition. Returns (z', U', g', stats)."""
    dim = z.shape[0]
    key, k_mom = jax.random.split(key)
    r0 = jax.random.normal(k_mom, (dim,), z.dtype) / jnp.sqrt(inv_mass)
    H0 = U_z + _kinetic(r0, inv_mass)
    s0 = IntegratorState(z, r0, U_z, g_z)

    def build_subtree(key, start: IntegratorState, direction, depth):
        """Integrate 2^depth new leaves outward from ``start``.

        Checkpoint slots: even leaf i stored at slot popcount(i); odd leaf i
        closes subtrees of size 2^m (m=1..trailing_ones(i)) starting at even
        leaf j=i-2^m+1 stored at slot popcount(j).
        """
        z_ckpt = jnp.zeros((max_depth + 1, dim), z.dtype)
        v_ckpt = jnp.zeros((max_depth + 1, dim), z.dtype)
        num_leaves = jnp.left_shift(jnp.int32(1), depth)
        eps_signed = direction.astype(z.dtype) * eps

        def cond(c):
            (i, _, _, _, _, _, _, _, turning, diverging, _, _, _) = c
            return (i < num_leaves) & (~turning) & (~diverging)

        def body(c):
            (i, key, s, z_p, U_p, g_p, logw, final, turning, diverging,
             acc, zc, vc) = c
            s = leapfrog(potential_vg, s, eps_signed, inv_mass)
            v = inv_mass * s.r
            H = s.U + _kinetic(s.r, inv_mass)
            delta = H - H0
            delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
            diverging = delta > _DIVERGENCE_THRESHOLD
            logw_leaf = -delta
            acc = acc + jnp.minimum(1.0, jnp.exp(-delta))

            # progressive multinomial sampling within the subtree
            logw_new = jnp.logaddexp(logw, logw_leaf)
            key, k_acc = jax.random.split(key)
            take = jnp.log(jax.random.uniform(k_acc)) < (logw_leaf - logw_new)
            z_p = jnp.where(take, s.z, z_p)
            U_p = jnp.where(take, s.U, U_p)
            g_p = jnp.where(take, s.g, g_p)

            is_even = (i % 2) == 0
            slot = _popcount(i)
            zc = jnp.where(is_even, zc.at[slot].set(s.z), zc)
            vc = jnp.where(is_even, vc.at[slot].set(v), vc)

            # U-turn checks against all subtrees closed by this odd leaf
            t_ones = _trailing_ones(i)

            def check(m, turn):
                j = i - jnp.left_shift(jnp.int32(1), m) + 1
                sj = _popcount(j)
                dz = direction.astype(z.dtype) * (s.z - zc[sj])
                bad = (jnp.dot(dz, vc[sj]) < 0.0) | (jnp.dot(dz, v) < 0.0)
                active = (~is_even) & (m <= t_ones) & (m >= 1)
                return turn | (active & bad)

            turning = jax.lax.fori_loop(1, max_depth + 1, check, turning)
            return (i + 1, key, s, z_p, U_p, g_p, logw_new, s, turning,
                    diverging, acc, zc, vc)

        init = (jnp.int32(0), key, start, start.z, start.U, start.g,
                jnp.asarray(-jnp.inf, z.dtype), start, jnp.bool_(False),
                jnp.bool_(False), jnp.zeros((), z.dtype), z_ckpt, v_ckpt)
        (i, key, _, z_p, U_p, g_p, logw, final, turning, diverging, acc,
         _, _) = jax.lax.while_loop(cond, body, init)
        return key, z_p, U_p, g_p, logw, final, turning, diverging, acc, i

    def cond(c: _TreeCarry):
        return (~c.turning) & (~c.diverging) & (c.depth < max_depth)

    def body(c: _TreeCarry):
        key, k_dir, k_swap = jax.random.split(c.key, 3)
        direction = jnp.where(jax.random.bernoulli(k_dir), jnp.int32(1),
                              jnp.int32(-1))
        start = jax.tree_util.tree_map(
            lambda a, b: jnp.where(direction > 0, a, b), c.right, c.left)
        (key, z_p, U_p, g_p, logw_sub, final, turning_sub, diverging, acc,
         n_new) = build_subtree(key, start, direction, c.depth)

        ok = (~turning_sub) & (~diverging)
        # biased progressive sampling across the doubling
        take = jnp.log(jax.random.uniform(k_swap)) < (logw_sub - c.logw)
        take = take & ok
        z_prop = jnp.where(take, z_p, c.z_prop)
        U_prop = jnp.where(take, U_p, c.U_prop)
        g_prop = jnp.where(take, g_p, c.g_prop)
        logw = jnp.where(ok, jnp.logaddexp(c.logw, logw_sub), c.logw)

        upd = lambda new, old: jax.tree_util.tree_map(
            lambda a, b: jnp.where(ok, a, b), new, old)
        left = upd(jax.tree_util.tree_map(
            lambda a, b: jnp.where(direction > 0, b, a), final, c.left), c.left)
        right = upd(jax.tree_util.tree_map(
            lambda a, b: jnp.where(direction > 0, a, b), final, c.right), c.right)

        # full-trajectory U-turn check
        dz = right.z - left.z
        full_turn = (jnp.dot(dz, inv_mass * left.r) < 0.0) | \
                    (jnp.dot(dz, inv_mass * right.r) < 0.0)
        turning = turning_sub | (ok & full_turn)
        return _TreeCarry(key, left, right, z_prop, U_prop, g_prop, logw,
                          c.depth + 1, turning, diverging,
                          c.accept_sum + acc, c.n_leaves + n_new)

    init = _TreeCarry(key, s0, s0, z, U_z, g_z,
                      jnp.zeros((), z.dtype), jnp.int32(0),
                      jnp.bool_(False), jnp.bool_(False),
                      jnp.zeros((), z.dtype), jnp.int32(0))
    out = jax.lax.while_loop(cond, body, init)
    accept_prob = out.accept_sum / jnp.maximum(out.n_leaves, 1)
    stats = {
        "accept_prob": accept_prob,
        "diverging": out.diverging,
        "depth": out.depth,
        "n_leapfrog": out.n_leaves,
        "energy": H0,
    }
    return out.z_prop, out.U_prop, out.g_prop, stats


# --------------------------------------------------------------------------
# Plain HMC transition (fixed leapfrog count + Metropolis correction)
# --------------------------------------------------------------------------

def hmc_kernel(potential_vg: Callable, z: jnp.ndarray, U_z: jnp.ndarray,
               g_z: jnp.ndarray, key: jnp.ndarray, eps: jnp.ndarray,
               inv_mass: jnp.ndarray, num_leapfrog: int = 10):
    """tfp-style HMC (reference: models/sgp_hmc.py:67-69 uses leapfrog=10)."""
    dim = z.shape[0]
    key, k_mom, k_mh = jax.random.split(key, 3)
    r0 = jax.random.normal(k_mom, (dim,), z.dtype) / jnp.sqrt(inv_mass)
    H0 = U_z + _kinetic(r0, inv_mass)
    s0 = IntegratorState(z, r0, U_z, g_z)

    def step(_, s):
        return leapfrog(potential_vg, s, eps, inv_mass)

    s = jax.lax.fori_loop(0, num_leapfrog, step, s0)
    H1 = s.U + _kinetic(s.r, inv_mass)
    delta = jnp.where(jnp.isnan(H1), jnp.inf, H1 - H0)
    accept_prob = jnp.minimum(1.0, jnp.exp(-delta))
    accept = jax.random.uniform(k_mh) < accept_prob
    z_new = jnp.where(accept, s.z, z)
    U_new = jnp.where(accept, s.U, U_z)
    g_new = jnp.where(accept, s.g, g_z)
    stats = {
        "accept_prob": accept_prob,
        "diverging": delta > _DIVERGENCE_THRESHOLD,
        "depth": jnp.int32(0),
        "n_leapfrog": jnp.int32(num_leapfrog),
        "energy": H0,
    }
    return z_new, U_new, g_new, stats


# --------------------------------------------------------------------------
# Adaptation: dual averaging + Welford diagonal mass, Stan window schedule
# --------------------------------------------------------------------------

class DAState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_avg: jnp.ndarray
    h_avg: jnp.ndarray
    mu: jnp.ndarray
    t: jnp.ndarray


def da_init(eps0):
    return DAState(jnp.log(eps0), jnp.log(eps0), jnp.zeros_like(eps0),
                   jnp.log(10.0 * eps0), jnp.zeros_like(eps0))


_DA_T0 = 10      # dual-averaging stabiliser t0 (Hoffman & Gelman 2014)


def da_update(s: DAState, accept_prob, target=0.8, gamma=0.05, t0=_DA_T0,
              kappa=0.75):
    t = s.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * s.h_avg + (target - accept_prob) / (t + t0)
    log_eps = s.mu - jnp.sqrt(t) / gamma * h_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * s.log_eps_avg
    return DAState(log_eps, log_eps_avg, h_avg, s.mu, t)


class WelfordState(NamedTuple):
    mean: jnp.ndarray
    m2: jnp.ndarray
    count: jnp.ndarray


def welford_init(dim, dtype):
    return WelfordState(jnp.zeros(dim, dtype), jnp.zeros(dim, dtype),
                        jnp.zeros((), dtype))


def welford_update(s: WelfordState, x):
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count
    m2 = s.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(s: WelfordState):
    """Stan-regularised diagonal variance estimate."""
    var = s.m2 / jnp.maximum(s.count - 1.0, 1.0)
    n = s.count
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))


def warmup_schedule(num_warmup: int, init_buffer: int = 75,
                    term_buffer: int = 50, base_window: int = 25):
    """(in_window, window_end) boolean arrays, Stan's expanding windows.

    A short warmup takes Stan's 15/75/10 split. Each window end restarts
    dual averaging, whose averaged step size needs about ``_DA_T0``
    iterations to settle; with fewer left after the last window (under 100
    warmup steps) the final step size is left several times too large, so
    such a warmup adapts the step size only, on the unit metric.
    """
    in_window = np.zeros(num_warmup, bool)
    window_end = np.zeros(num_warmup, bool)
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.10 * num_warmup))
        base_window = max(1, num_warmup - init_buffer - term_buffer)
        if term_buffer < _DA_T0:
            return jnp.asarray(in_window), jnp.asarray(window_end)
    t = init_buffer
    w = base_window
    while t < num_warmup - term_buffer:
        end = t + w
        if end + 2 * w > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        in_window[t:end] = True
        window_end[end - 1] = True
        t = end
        w *= 2
    return jnp.asarray(in_window), jnp.asarray(window_end)


def find_reasonable_step_size(potential_vg, z, U_z, g_z, key, inv_mass,
                              init_eps=1.0, target=0.8):
    """Hoffman & Gelman Algorithm 4: double/halve eps until the one-step
    accept probability crosses 0.5."""
    dim = z.shape[0]
    r0 = jax.random.normal(key, (dim,), z.dtype) / jnp.sqrt(inv_mass)
    H0 = U_z + _kinetic(r0, inv_mass)
    s0 = IntegratorState(z, r0, U_z, g_z)

    def accept_at(eps):
        s = leapfrog(potential_vg, s0, eps, inv_mass)
        H = s.U + _kinetic(s.r, inv_mass)
        return jnp.where(jnp.isnan(H), -jnp.inf, H0 - H)

    eps = jnp.asarray(init_eps, z.dtype)
    la0 = accept_at(eps)
    direction = jnp.where(la0 > jnp.log(0.5), 1.0, -1.0)

    def cond(c):
        eps, la, i = c
        crossed = jnp.where(direction > 0, la <= jnp.log(0.5),
                            la > jnp.log(0.5))
        return (~crossed) & (i < 64) & (eps > 1e-10) & (eps < 1e7)

    def body(c):
        eps, la, i = c
        eps = eps * jnp.where(direction > 0, 2.0, 0.5)
        return eps, accept_at(eps), i + 1      # one potential eval per step

    eps, _, _ = jax.lax.while_loop(cond, body, (eps, la0, jnp.int32(0)))
    # one step back on the shrinking branch so we end on the "accepting" side
    return jnp.where(direction > 0, eps * 0.5, eps)


# --------------------------------------------------------------------------
# Full sampler driver
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    num_warmup: int = 500
    num_samples: int = 500
    max_depth: int = 8
    target_accept: float = 0.8
    algorithm: str = "nuts"          # "nuts" | "hmc"
    num_leapfrog: int = 10           # hmc only
    adapt_mass: bool = True
    init_step_size: float = 0.1


def _make_warm_step(potential_vg, kernel, cfg: NUTSConfig, dim, dtype):
    """One warmup transition + adaptation update, shared by the monolithic
    (_single_chain) and chunked (build_sampler_chunked) drivers so their
    adaptation logic can never diverge."""

    def warm_step(z, U, g, key, da, wf, inv_mass, in_w, w_end):
        key, k_step = jax.random.split(key)
        eps = jnp.exp(da.log_eps)
        z, U, g, stats = kernel(potential_vg, z, U, g, k_step, eps, inv_mass)
        da = da_update(da, stats["accept_prob"], cfg.target_accept)
        if cfg.adapt_mass:
            wf = jax.tree_util.tree_map(
                lambda a, b: jnp.where(in_w, a, b), welford_update(wf, z), wf)
            inv_mass = jnp.where(w_end, welford_variance(wf), inv_mass)
            # window end: reset welford + restart dual averaging at current eps
            wf = jax.tree_util.tree_map(
                lambda a, b: jnp.where(w_end, a, b), welford_init(dim, dtype),
                wf)
            da = jax.tree_util.tree_map(
                lambda a, b: jnp.where(w_end, a, b),
                da_init(jnp.exp(da.log_eps)), da)
        return z, U, g, key, da, wf, inv_mass, stats

    return warm_step


def _single_chain(potential_vg, z0, key, cfg: NUTSConfig, in_window,
                  window_end):
    dim = z0.shape[0]
    dtype = z0.dtype
    U0, g0 = potential_vg(z0)
    inv_mass = jnp.ones(dim, dtype)

    key, k_eps = jax.random.split(key)
    eps = find_reasonable_step_size(potential_vg, z0, U0, g0, k_eps, inv_mass,
                                    cfg.init_step_size)
    da = da_init(eps)
    wf = welford_init(dim, dtype)

    if cfg.algorithm == "nuts":
        kernel = partial(nuts_kernel, max_depth=cfg.max_depth)
    else:
        kernel = partial(hmc_kernel, num_leapfrog=cfg.num_leapfrog)

    warm = _make_warm_step(potential_vg, kernel, cfg, dim, dtype)

    def warm_step(carry, inputs):
        in_w, w_end = inputs
        *state, stats = warm(*carry, in_w, w_end)
        return tuple(state), stats["accept_prob"]

    carry = (z0, U0, g0, key, da, wf, inv_mass)
    carry, _ = jax.lax.scan(warm_step, carry, (in_window, window_end))
    (z, U, g, key, da, wf, inv_mass) = carry
    eps = jnp.exp(da.log_eps_avg)

    def sample_step(carry, _):
        z, U, g, key = carry
        key, k_step = jax.random.split(key)
        z, U, g, stats = kernel(potential_vg, z, U, g, k_step, eps, inv_mass)
        return (z, U, g, key), (z, stats)

    (_, _, _, _), (zs, stats) = jax.lax.scan(
        sample_step, (z, U, g, key), None, length=cfg.num_samples)
    stats["step_size"] = eps
    stats["inv_mass"] = inv_mass
    return zs, stats


def build_sampler(logprob_fn: Callable, example_params, cfg: NUTSConfig,
                  num_chains: int = 1, jitter_init: float = 0.1, mesh=None):
    """Compile-once sampler factory.

    ``logprob_fn(params, data)`` — ``data`` is an arbitrary pytree traced as
    an argument, so repeated calls with new data (e.g. updated inducing
    locations in the alternating trainer, models/bayesian_sgpr_hmc.py:88-158)
    reuse the same executable with zero recompilation.

    ``mesh``: a Mesh with a ``chains`` axis — chains shard across devices
    (data pytree replicated). The reference has no chain parallelism at all
    (every sampler call is chains=1, models/bayesian_sgpr_hmc.py:78).

    Returns ``sample(init_params, key, data) -> (samples, stats)`` with
    samples leading axes ``(num_chains, num_samples)``.
    """
    _, unravel = jax.flatten_util.ravel_pytree(example_params)
    in_window, window_end = warmup_schedule(cfg.num_warmup)

    if mesh is not None and num_chains % mesh.shape["chains"] != 0:
        raise ValueError(f"num_chains={num_chains} must divide evenly over "
                         f"the mesh chains axis ({mesh.shape['chains']})")

    @jax.jit
    def _run(flat0, key, data):
        def potential_vg(zvec):
            return jax.value_and_grad(
                lambda v: -logprob_fn(unravel(v), data))(zvec)

        keys = jax.random.split(key, num_chains)
        jkeys = jax.random.split(jax.random.fold_in(key, 1), num_chains)
        z0s = jnp.stack([
            flat0 + jitter_init * jax.random.normal(k, flat0.shape, flat0.dtype)
            for k in jkeys])
        if mesh is not None:
            # GSPMD: pin the chain axis onto the device mesh; the vmapped
            # chain computation then partitions across devices with no
            # cross-chain communication
            from jax.sharding import NamedSharding, PartitionSpec as P
            sh = NamedSharding(mesh, P("chains"))
            z0s = jax.lax.with_sharding_constraint(z0s, sh)
            keys = jax.lax.with_sharding_constraint(keys, sh)
        return jax.vmap(
            lambda z0, k: _single_chain(potential_vg, z0, k, cfg, in_window,
                                        window_end))(z0s, keys)

    def sample(init_params, key, data=None):
        flat0, _ = jax.flatten_util.ravel_pytree(init_params)
        zs, stats = _run(flat0, key, data)      # (C, S, dim)
        samples = jax.vmap(jax.vmap(unravel))(zs)
        return samples, stats

    return sample


def run_nuts(logprob_fn: Callable, init_params, key, cfg: NUTSConfig = NUTSConfig(),
             num_chains: int = 1):
    """One-shot convenience wrapper around :func:`build_sampler`.

    Returns ``(samples, stats)`` where samples is a pytree with leading axes
    ``(num_chains, num_samples)``. The whole of warmup + sampling is one jit
    per chain, vmapped over chains.
    """
    sampler = build_sampler(lambda p, _: logprob_fn(p), init_params, cfg,
                            num_chains)
    return sampler(init_params, key, None)


def build_sampler_chunked(logprob_fn: Callable, example_params,
                          cfg: NUTSConfig, num_chains: int = 1,
                          jitter_init: float = 0.1, mesh=None,
                          chunk_size: int = 100):
    """Like :func:`build_sampler`, but warmup and sampling run as a sequence
    of bounded-length program invocations of at most ``chunk_size``
    transitions each (three compiled executables total: init, warm chunk,
    sample chunk).

    Why: the host regains control between chunks, so progress reporting and
    sampler-state checkpointing (kill and resume) become possible.
    Warmup length is rounded UP to a multiple of ``chunk_size`` (extra
    adaptation steps are harmless). Sampling length rounds up too; excess
    draws are trimmed.
    """
    _, unravel = jax.flatten_util.ravel_pytree(example_params)

    def _make_pvg(data):
        return lambda zvec: jax.value_and_grad(
            lambda v: -logprob_fn(unravel(v), data))(zvec)

    n_warm_chunks = -(-cfg.num_warmup // chunk_size)
    warm_total = n_warm_chunks * chunk_size
    in_w_np, w_end_np = warmup_schedule(cfg.num_warmup)
    pad = warm_total - cfg.num_warmup
    in_w = jnp.concatenate([jnp.asarray(in_w_np), jnp.zeros(pad, bool)])
    w_end = jnp.concatenate([jnp.asarray(w_end_np), jnp.zeros(pad, bool)])
    n_sample_chunks = -(-cfg.num_samples // chunk_size)

    if cfg.algorithm == "nuts":
        kernel = partial(nuts_kernel, max_depth=cfg.max_depth)
    else:
        kernel = partial(hmc_kernel, num_leapfrog=cfg.num_leapfrog)

    def _shard(x):
        if mesh is None:
            return x
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P("chains")))

    @jax.jit
    def _init(flat0, key, data):
        pvg = _make_pvg(data)

        keys = jax.random.split(key, num_chains)
        jkeys = jax.random.split(jax.random.fold_in(key, 1), num_chains)
        z0s = _shard(jnp.stack([
            flat0 + jitter_init * jax.random.normal(k, flat0.shape,
                                                    flat0.dtype)
            for k in jkeys]))
        keys = _shard(keys)

        def one(z0, k):
            dim = z0.shape[0]
            U0, g0 = pvg(z0)
            inv_mass = jnp.ones(dim, z0.dtype)
            k, k_eps = jax.random.split(k)
            eps = find_reasonable_step_size(pvg, z0, U0, g0, k_eps, inv_mass,
                                            cfg.init_step_size)
            return dict(z=z0, U=U0, g=g0, key=k, da=da_init(eps),
                        wf=welford_init(dim, z0.dtype), inv_mass=inv_mass)

        return jax.vmap(one)(z0s, keys)

    @jax.jit
    def _warm_chunk(carry, in_w_c, w_end_c, data):
        pvg = _make_pvg(data)

        def one(c):
            warm = _make_warm_step(pvg, kernel, cfg, c["z"].shape[0],
                                   c["z"].dtype)

            def step(s, inputs):
                in_wi, w_endi = inputs
                z, U, g, key, da, wf, inv_mass, _ = warm(
                    s["z"], s["U"], s["g"], s["key"], s["da"], s["wf"],
                    s["inv_mass"], in_wi, w_endi)
                return dict(z=z, U=U, g=g, key=key, da=da, wf=wf,
                            inv_mass=inv_mass), None

            c, _ = jax.lax.scan(step, c, (in_w_c, w_end_c))
            return c

        return jax.vmap(one)(carry)

    @jax.jit
    def _sample_chunk(carry, data):
        pvg = _make_pvg(data)

        def one(c):
            eps = jnp.exp(c["da"].log_eps_avg)

            def step(s, _):
                key, k_step = jax.random.split(s["key"])
                z, U, g, stats = kernel(pvg, s["z"], s["U"], s["g"], k_step,
                                      eps, s["inv_mass"])
                return {**s, "z": z, "U": U, "g": g, "key": key}, (z, stats)

            c, (zs, stats) = jax.lax.scan(step, c, None, length=chunk_size)
            return c, zs, stats

        return jax.vmap(one)(carry)

    def sample(init_params, key, data=None, progress: Callable | None = None,
               ckpt_manager=None):
        """``ckpt_manager``: a ggp_tpu.utils.checkpoint.CheckpointManager —
        the sampler carry is checkpointed after every chunk and, when a
        checkpoint exists, warmup/sampling RESUME from it (chunk
        granularity), pairing the two subsystems the reference lacks
        entirely (SURVEY §5.4: no checkpointing; §5.1: no progress)."""
        flat0, _ = jax.flatten_util.ravel_pytree(init_params)
        carry = _init(flat0, key, data)
        start_chunk = 0
        run_sig = {"chunk_size": chunk_size, "num_warmup": cfg.num_warmup,
                   "num_samples": cfg.num_samples,
                   "algorithm": cfg.algorithm, "num_chains": num_chains}
        if ckpt_manager is not None:
            restored, meta = ckpt_manager.restore(carry)
            if restored is not None:
                saved_sig = {k: meta.get(k) for k in run_sig}
                if saved_sig != run_sig:
                    raise ValueError(
                        f"checkpoint was written by a different sampler "
                        f"configuration ({saved_sig} != {run_sig}) - resuming "
                        f"would misalign the warmup schedule")
                carry = restored
                # resume skips completed WARMUP chunks only; sampling always
                # reruns in full so callers get exactly num_samples draws
                start_chunk = min(int(meta.get("chunk", 0)), n_warm_chunks)
        zs_chunks, stats_chunks = [], []
        for i in range(start_chunk, n_warm_chunks):
            sl = slice(i * chunk_size, (i + 1) * chunk_size)
            carry = _warm_chunk(carry, in_w[sl], w_end[sl], data)
            jax.block_until_ready(carry["z"])
            if ckpt_manager is not None:
                ckpt_manager.save(i + 1, carry, {"chunk": i + 1, **run_sig})
            if progress:
                progress("warmup", (i + 1) * chunk_size, warm_total)
        for i in range(n_sample_chunks):
            carry, zs, stats = _sample_chunk(carry, data)
            jax.block_until_ready(zs)
            zs_chunks.append(zs)
            stats_chunks.append(stats)
            if ckpt_manager is not None:
                # sampling checkpoints stay capped at the post-warmup chunk
                # id so a resume never skips draws
                ckpt_manager.save(n_warm_chunks, carry,
                                  {"chunk": n_warm_chunks, **run_sig})
            if progress:
                progress("sample", (i + 1) * chunk_size,
                         n_sample_chunks * chunk_size)
        zs = jnp.concatenate(zs_chunks, axis=1)[:, :cfg.num_samples]
        stats = jax.tree_util.tree_map(
            lambda *a: jnp.concatenate(a, axis=1)[:, :cfg.num_samples],
            *stats_chunks)
        stats["step_size"] = jnp.exp(carry["da"].log_eps_avg)
        stats["inv_mass"] = carry["inv_mass"]
        samples = jax.vmap(jax.vmap(unravel))(zs)
        return samples, stats

    return sample

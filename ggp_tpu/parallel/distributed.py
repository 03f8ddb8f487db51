"""Multi-process (multi-host) initialisation.

The reference has no distributed communication layer at all (SURVEY §2.4/
§5.8: joblib local processes only, experiments/regression.py:219-231).
Single-process multi-device sharding is first-class here via
``ggp_tpu.parallel.make_mesh`` + GSPMD; THIS module covers the remaining
step to several hosts: one JAX process per host joined through
``jax.distributed.initialize``, after which ``jax.devices()`` is the global
device set, ``make_mesh()`` builds a cluster-wide (chains, data) mesh, and
every sharded sampler/optimiser in the package runs unchanged — XLA routes
the ``psum``/``all_gather`` collectives over NVLink within a host and the
network across hosts.

Pass ``coordinator_address``/``num_processes``/``process_id`` explicitly
unless a cluster manager (e.g. Slurm) provides them. Multi-process behaviour
is covered by a same-host two-process smoke (tests/test_parallel.py) and the
virtual-mesh sharding tests; the code path is the standard JAX one.
"""

from __future__ import annotations

from typing import Optional

import jax

__all__ = ["initialize_distributed", "global_mesh", "is_distributed"]

_initialized = [False]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> dict:
    """Join (or create) the multi-process JAX runtime; idempotent.

    Returns a summary dict {process_id, num_processes, local_devices,
    global_devices}. With no arguments, relies on JAX's cluster
    auto-detection (e.g. Slurm).
    """
    if not _initialized[0]:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        _initialized[0] = True
    return {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_distributed() -> bool:
    return jax.process_count() > 1


def global_mesh(chains_axis: Optional[int] = None):
    """Cluster-wide (chains, data) mesh over the GLOBAL device set — drop-in
    for the model ``mesh=`` arguments (chains shard across hosts too;
    data-axis psums stay within a host first by construction of the device
    order)."""
    from .mesh import make_mesh
    return make_mesh(devices=jax.devices(), chains_axis=chains_axis)

"""Device-mesh helpers.

The reference has NO distributed layer (SURVEY §2.4 — joblib process fan-out
only, experiments/regression.py:219-231). Here parallelism is native:
a 2D ``(chains, data)`` mesh where

* ``chains`` shards independent HMC chains / ensemble members (the analogue
  of data parallelism for MCMC — the reference always ran chains=1,
  models/bayesian_sgpr_hmc.py:78),
* ``data``  shards the N training rows of the VFE statistics (the analogue
  of sequence/context parallelism; collectives are ``psum`` over NVLink).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "chain_sharding", "data_sharding", "P", "Mesh",
           "NamedSharding"]


def make_mesh(num_devices: Optional[int] = None, chains_axis: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (chains, data) mesh over the available devices.

    ``chains_axis`` defaults to the largest power-of-two divisor <= half the
    devices (so both axes are non-trivial when possible).
    """
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    n = len(devices)
    if chains_axis is None:
        chains_axis = 1
        while n % (chains_axis * 2) == 0 and chains_axis * 2 <= n // 2:
            chains_axis *= 2
        if n > 1 and n % 2 == 0 and chains_axis == 1:
            chains_axis = 2 if n > 2 else 1
    data_axis = n // chains_axis
    dev_grid = np.asarray(devices[:chains_axis * data_axis]).reshape(
        chains_axis, data_axis)
    return Mesh(dev_grid, axis_names=("chains", "data"))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis sharded over chains, replicated over data."""
    return NamedSharding(mesh, P("chains"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis sharded over data rows, replicated over chains."""
    return NamedSharding(mesh, P("data"))

"""Device mesh helpers for chain-parallel execution.

The framework's data-parallel axis is the *chain* axis (SURVEY.md section
2.4): thousands of chains per chip, sharded across devices and hosts over
a 1-D ``"chains"`` mesh.  All kernel math is batched elementwise / matmul
over the leading chain axis, so GSPMD partitions a jitted step along the
mesh with zero per-step communication; collectives only appear in
adaptation / diagnostics reductions.

Multi-host: ``initialize_distributed`` wraps ``jax.distributed.initialize``
so the same program runs across hosts; tests exercise the mesh path on a
virtual 8-device CPU backend (``tests/conftest.py``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

CHAIN_AXIS = "chains"


def make_mesh(num_devices: int | None = None, axis_name: str = CHAIN_AXIS) -> Mesh:
    """1-D mesh over the first ``num_devices`` devices (default: all)."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def chain_sharding(mesh: Mesh, ndim: int = 2, axis_name: str = CHAIN_AXIS) -> NamedSharding:
    """Shard the leading (chain) axis; replicate the rest."""
    return NamedSharding(mesh, PartitionSpec(axis_name, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_chains(mesh: Mesh, tree, axis_name: str = CHAIN_AXIS):
    """Device_put every leaf with its leading axis sharded over the mesh."""

    def put(x):
        return jax.device_put(x, chain_sharding(mesh, max(x.ndim, 1), axis_name))

    return jax.tree.map(put, tree)


def initialize_distributed(**kwargs) -> None:
    """Multi-host bring-up: ``jax.distributed.initialize`` with idempotence.

    Exercised end-to-end by ``tests/test_distributed.py`` (2 coordinated
    CPU processes, Gloo collectives).  Re-initialization is a no-op;
    genuine bring-up failures (bad coordinator address, rank mismatch)
    propagate.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" not in str(e).lower():  # idempotent re-init only
            raise

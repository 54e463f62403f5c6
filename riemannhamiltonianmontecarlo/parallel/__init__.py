"""Execution layer: chain runner, device mesh, collectives, adaptation."""

from riemannhamiltonianmontecarlo.parallel.mesh import (
    CHAIN_AXIS,
    chain_sharding,
    initialize_distributed,
    make_mesh,
    replicated,
    shard_chains,
)
from riemannhamiltonianmontecarlo.parallel.adaptation import (
    AdaptationConfig,
    adaptive,
    frozen_step_size,
    run_adaptive,
)
from riemannhamiltonianmontecarlo.parallel.collectives import (
    cross_chain_mean,
    cross_chain_sum,
)
from riemannhamiltonianmontecarlo.parallel.monitor import monitor, profile_trace
from riemannhamiltonianmontecarlo.parallel.runner import RunResult, run, run_checkpointed

__all__ = [
    "AdaptationConfig",
    "adaptive",
    "frozen_step_size",
    "run_adaptive",
    "cross_chain_mean",
    "cross_chain_sum",
    "monitor",
    "profile_trace",
    "CHAIN_AXIS",
    "make_mesh",
    "chain_sharding",
    "replicated",
    "shard_chains",
    "initialize_distributed",
    "run",
    "run_checkpointed",
    "RunResult",
]

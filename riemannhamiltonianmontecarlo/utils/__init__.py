"""Utilities: configuration presets, checkpointing, compile cache."""

from riemannhamiltonianmontecarlo.utils.config import (
    ExperimentConfig,
    reference_preset,
)
from riemannhamiltonianmontecarlo.utils.checkpoint import load_state, save_state
from riemannhamiltonianmontecarlo.utils.compile_cache import enable_compile_cache
from riemannhamiltonianmontecarlo.utils.device import device_record, gpu_name_and_power_limit
from riemannhamiltonianmontecarlo.utils.init import (
    default_init,
    jittered_init,
    map_estimate,
)

__all__ = [
    "ExperimentConfig",
    "reference_preset",
    "default_init",
    "jittered_init",
    "map_estimate",
    "save_state",
    "load_state",
    "enable_compile_cache",
    "device_record",
    "gpu_name_and_power_limit",
]

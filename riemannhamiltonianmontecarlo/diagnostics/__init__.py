"""Diagnostics: ESS (reference-compatible Geyer estimator), R-hat, summaries."""

from riemannhamiltonianmontecarlo.diagnostics.ess import (
    autocorrelation,
    ess_geyer,
    ess_geyer_device,
    ess_multichain,
    nextpow2,
)
from riemannhamiltonianmontecarlo.diagnostics import native, plots
from riemannhamiltonianmontecarlo.diagnostics.geweke import geweke_z
from riemannhamiltonianmontecarlo.diagnostics.native import ess_geyer_native
from riemannhamiltonianmontecarlo.diagnostics.rhat import split_rhat, split_rhat_device

__all__ = [
    "autocorrelation",
    "ess_geyer",
    "ess_geyer_device",
    "ess_multichain",
    "nextpow2",
    "native",
    "plots",
    "ess_geyer_native",
    "geweke_z",
    "split_rhat",
    "split_rhat_device",
]

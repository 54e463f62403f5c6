"""Model zoo: log-posteriors with gradients and Fisher-metric geometry."""

from riemannhamiltonianmontecarlo.models import datasets, fhn, lgc, stochvol
from riemannhamiltonianmontecarlo.models.base import (
    FunctionModel,
    ManifoldModel,
    Model,
    autodiff_manifold,
)
from riemannhamiltonianmontecarlo.models.datasets import (
    Dataset,
    load_dataset,
    synthetic_logreg,
)
from riemannhamiltonianmontecarlo.models.logreg import LogisticRegression, ManifoldState

from riemannhamiltonianmontecarlo.models.fhn import FHNModel
from riemannhamiltonianmontecarlo.models.lgc import LGCJointModel, LGCModel
from riemannhamiltonianmontecarlo.models.stochvol import StochVolModel

__all__ = [
    "datasets",
    "fhn",
    "lgc",
    "stochvol",
    "FHNModel",
    "LGCModel",
    "LGCJointModel",
    "StochVolModel",
    "Dataset",
    "load_dataset",
    "synthetic_logreg",
    "LogisticRegression",
    "ManifoldState",
    "Model",
    "ManifoldModel",
    "FunctionModel",
    "autodiff_manifold",
]

"""Chain-batched Riemann-manifold MCMC framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``emilemathieu/RiemannHamiltonianMonteCarlo`` (Girolami & Calderhead 2011,
"Riemann manifold Langevin and Hamiltonian Monte Carlo methods", JRSS-B):
Bayesian logistic regression, stochastic volatility, log-Gaussian Cox and
FitzHugh-Nagumo ODE models sampled by adaptive Metropolis, HMC, MALA,
(simplified) mMALA, IWLS, auxiliary-variable Gibbs and (Student-t) RMHMC.

Design (see SURVEY.md section 7): the reference fuses model math into each
sampler file; here the decomposition is orthogonal:

* :mod:`~riemannhamiltonianmontecarlo.models` -- log-posteriors with
  closed-form gradients / Fisher metrics / metric-derivative contractions.
* :mod:`~riemannhamiltonianmontecarlo.samplers` -- batched transition
  kernels operating on a leading chain axis (thousands of chains per chip).
* :mod:`~riemannhamiltonianmontecarlo.parallel` -- `lax.scan` chain
  runner, `shard_map` over a device mesh, cross-host collectives.
* :mod:`~riemannhamiltonianmontecarlo.diagnostics` -- ESS (Geyer
  initial-monotone estimator, semantics-compatible with the reference),
  split R-hat, summaries.
* :mod:`~riemannhamiltonianmontecarlo.ops` -- batched small-matrix
  linear algebra (chain-vectorized Cholesky / triangular solves).

Import alias convention: ``import riemannhamiltonianmontecarlo as rhmc``.
"""

__version__ = "0.1.0"

from riemannhamiltonianmontecarlo import diagnostics, models, ops, parallel, samplers, utils

__all__ = [
    "models",
    "samplers",
    "ops",
    "parallel",
    "diagnostics",
    "utils",
    "__version__",
]

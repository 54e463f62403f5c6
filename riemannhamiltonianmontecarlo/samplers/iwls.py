"""Iterated-weighted-least-squares MH sampler (Gamerman 1997).

Statistical contract from the reference (``code/iwls.py:13-89`` / MATLAB
``MCMC/BLR_IWLS.m:190-240``):

* proposal = Gaussian whose mean/covariance come from one Newton/IWLS
  step at the *current* point: cov = (I/alpha + X^T W X)^{-1},
  mean = cov X^T W z with z = Xw + W^{-1}(t - p)  (``code/iwls.py:28-35``);
* the proposal parameters of the current point are cached and refreshed
  only on accept (``code/iwls.py:76-81``);
* asymmetric MH correction using both proposal densities; the reference
  adds 1e-6 Cholesky jitter for the log-determinant (``code/iwls.py:64``)
  -- here the same jitter feeds both the log-det and the quadratic form
  (difference O(1e-6) in the MH ratio).

The model must provide ``iwls_proposal(w) -> (mean, cov)``
(``models/logreg.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo import ops
from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel, metropolis_accept, tree_where

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class IWLSConfig:
    jitter: float = 1e-6  # code/iwls.py:64


class IWLSState(NamedTuple):
    position: Array  # (C, D)
    logp: Array  # (C,)
    mean: Array  # (C, D) IWLS proposal mean at current position
    chol_cov: Array  # (C, D, D) lower Cholesky of the proposal covariance


def build(model, config: IWLSConfig = IWLSConfig()) -> Kernel:
    def proposal(w: Array):
        mean, cov = model.iwls_proposal(w)
        cov = cov + config.jitter * jnp.eye(cov.shape[-1], dtype=cov.dtype)
        return mean, ops.cholesky(cov)

    def log_q(mean: Array, chol_cov: Array, x: Array) -> Array:
        delta = x - mean
        y = ops.solve_lower_triangular(chol_cov, delta)
        half_logdet = jnp.sum(
            jnp.log(jnp.diagonal(chol_cov, axis1=-2, axis2=-1)), axis=-1
        )
        return -half_logdet - 0.5 * jnp.sum(y * y, axis=-1)

    def init(position: Array) -> IWLSState:
        mean, chol_cov = proposal(position)
        return IWLSState(position, model.logp(position), mean, chol_cov)

    def step(key: Array, state: IWLSState) -> tuple[IWLSState, Info]:
        k_prop, k_acc = jax.random.split(key)
        w_new = state.mean + ops.mvn_sample(k_prop, state.chol_cov)
        logp_new = model.logp(w_new)
        mean_new, chol_new = proposal(w_new)

        log_q_fwd = log_q(state.mean, state.chol_cov, w_new)
        log_q_rev = log_q(mean_new, chol_new, state.position)

        ratio = logp_new + log_q_rev - state.logp - log_q_fwd
        divergent = ~(jnp.isfinite(ratio) & jnp.all(jnp.isfinite(w_new), axis=-1))
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        new_state = tree_where(
            accept, IWLSState(w_new, logp_new, mean_new, chol_new), state
        )
        return new_state, Info(accept_prob, accept, divergent)

    return Kernel(init, step)

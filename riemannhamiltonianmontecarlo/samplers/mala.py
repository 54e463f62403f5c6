"""Metropolis-adjusted Langevin algorithm (MALA).

Statistical contract from the reference MATLAB (``MCMC/BLR_MALA.m``):

* proposal mean ``w + eps/(2 s) * grad log pi(w)``, covariance
  ``(eps / s) I``  (``BLR_MALA.m:199-201``);
* MH correction with both asymmetric proposal densities
  (``BLR_MALA.m:204-216``);
* *transient vs stationary scaling*: ``s = 2 sqrt(D)`` during burn-in,
  ``s = D^(1/3)`` afterwards (``BLR_MALA.m:167`` and the reset at the
  burn-in boundary ``BLR_MALA.m:243``), following Roberts & Rosenthal
  optimal-scaling theory.

Build one kernel per phase (``transient=True`` for warmup) and pass the
warmup kernel to ``parallel.run(..., warmup_kernel=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel, metropolis_accept, tree_where

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class MALAConfig:
    step_size: float = 0.1  # per-dataset switch block, e.g. BLR_MALA.m:35
    transient: bool = False  # True -> scaling k sqrt(D); False -> D^(1/3)
    # Transient-phase multiplier on sqrt(D): 1 for most datasets
    # (BLR_MALA.m:36), 2 for ripley (BLR_MALA.m:167).
    transient_factor: float = 1.0

    def scaling(self, dim: int) -> float:
        if self.transient:
            return self.transient_factor * dim**0.5
        return dim ** (1.0 / 3.0)


class MALAState(NamedTuple):
    position: Array  # (C, D)
    logp: Array  # (C,)
    grad: Array  # (C, D)


def build(model, config: MALAConfig = MALAConfig()) -> Kernel:
    def init(position: Array) -> MALAState:
        logp, grad = model.logp_and_grad(position)
        return MALAState(position, logp, grad)

    def step(key: Array, state: MALAState) -> tuple[MALAState, Info]:
        d = state.position.shape[-1]
        s = config.scaling(d)
        drift = config.step_size / (2.0 * s)
        var = config.step_size / s

        k_prop, k_acc = jax.random.split(key)
        mean_fwd = state.position + drift * state.grad
        noise = jax.random.normal(k_prop, state.position.shape, state.position.dtype)
        w_new = mean_fwd + jnp.sqrt(var) * noise

        logp_new, grad_new = model.logp_and_grad(w_new)
        mean_rev = w_new + drift * grad_new

        # log q densities up to the shared normalizing constant.
        log_q_fwd = -0.5 * jnp.sum((w_new - mean_fwd) ** 2, axis=-1) / var
        log_q_rev = -0.5 * jnp.sum((state.position - mean_rev) ** 2, axis=-1) / var

        ratio = logp_new + log_q_rev - state.logp - log_q_fwd
        divergent = ~jnp.isfinite(ratio)
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        new_state = tree_where(accept, MALAState(w_new, logp_new, grad_new), state)
        return new_state, Info(accept_prob, accept, divergent)

    return Kernel(init, step)

"""Manifold MALA with a constant dense metric (preconditioned MALA).

The reference's LGC latent-field mMALA freezes the Fisher metric at the
prior mean BEFORE the sampling loop -- ``LGC_mMALA_LV.m:85-92`` builds
G = Sigma^{-1} + diag(m e^{mu + diag Sigma}) once (CholG / InvG /
CholInvG precomputed), and each iteration is a preconditioned Langevin
proposal: mean = x + (eps/2) G^{-1} grad L, covariance eps G^{-1}
(``:115-121``; their StepSize scales the VARIANCE, i.e. it is the
eps^2 of the usual MALA notation), accepted with both proposal
densities whose log-dets cancel (``:120,129``).

The round-2..4 implementation instead ran the position-dependent
``samplers/mmala.py`` on LGC -- a per-step batched D=4096 Cholesky,
O(D^3) per chain per step, for an algorithm the reference never runs on
this workload.  This kernel is the faithful contract and its per-step
cost is a handful of (C, D) x (D, D) matvecs.

Generic over models: supply (chol(G), G^{-1}) exactly like ``phmc``;
the identity matrices recover plain MALA.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.samplers.base import (
    Info,
    Kernel,
    metropolis_accept,
    tree_where,
)

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class PMALAConfig:
    # Variance-scale step (the reference's StepSize enters the proposal
    # covariance LINEARLY: cov = step_size * G^{-1}, LGC_mMALA_LV.m:34,121).
    step_size: float = 0.07  # LGC_mMALA_LV.m:34


class PMALAState(NamedTuple):
    position: Array  # (C, D)
    logp: Array  # (C,)
    grad: Array  # (C, D) cached grad log-posterior at position


def build(model, mass_chol: Array, mass_inv: Array,
          config: PMALAConfig = PMALAConfig(), *,
          quad_fn=None, factor_only: bool = False) -> Kernel:
    """``mass_chol``: lower Cholesky L of the constant metric G (D, D);
    ``mass_inv``: G^{-1}.  One ``logp_and_grad`` per step (the reverse
    drift reuses the proposal's gradient, which the next step then
    inherits on acceptance).

    Large-D options (both used for LGC D=4096, where every dense (D, D)
    constant baked into the jitted program is 67 MB):

    * ``quad_fn(delta) -> (C,)``: model-supplied delta^T G delta (e.g.
      ``LGCModel.metric_quad`` reuses the Sigma^{-1} operator the
      gradient already needs), replacing the ``mass_chol`` matmul;
    * ``factor_only``: drop ``mass_inv`` from the program too -- the
      drift applies G^{-1} = L^{-T} L^{-1} as two matmuls with the one
      precomputed triangular inverse.
    """
    eps = config.step_size
    half = 0.5 * eps
    sqrt_eps = eps ** 0.5
    # x = z @ L^{-1} has covariance (L L^T)^{-1} = G^{-1}; the triangular
    # inverse is a one-time build cost, keeping the per-step noise a
    # single (C, D) x (D, D) matmul instead of a triangular solve.
    d = mass_chol.shape[0]
    inv_chol = jax.scipy.linalg.solve_triangular(
        mass_chol, jnp.eye(d, dtype=mass_chol.dtype), lower=True)

    if quad_fn is None:
        def quad_fn(delta: Array) -> Array:
            """delta^T G delta via the factor: ||delta @ L||^2."""
            y = jnp.matmul(delta, mass_chol, precision=_PREC)
            return jnp.sum(y * y, axis=-1)

    if factor_only:
        def apply_g_inv(g: Array) -> Array:
            # g G^{-1} = (g L^{-T}) L^{-1}, row-vector convention.
            return jnp.matmul(
                jnp.matmul(g, inv_chol.T, precision=_PREC), inv_chol,
                precision=_PREC)
    else:
        def apply_g_inv(g: Array) -> Array:
            return jnp.matmul(g, mass_inv, precision=_PREC)

    def drift(position: Array, grad: Array) -> Array:
        return position + half * apply_g_inv(grad)

    def init(position: Array) -> PMALAState:
        logp, grad = model.logp_and_grad(position)
        return PMALAState(position, logp, grad)

    def step(key: Array, state: PMALAState) -> tuple[PMALAState, Info]:
        k_noise, k_acc = jax.random.split(key)
        mean_fwd = drift(state.position, state.grad)
        z = jax.random.normal(k_noise, state.position.shape,
                              state.position.dtype)
        x_prop = mean_fwd + sqrt_eps * jnp.matmul(z, inv_chol, precision=_PREC)

        logp_prop, grad_prop = model.logp_and_grad(x_prop)
        mean_rev = drift(x_prop, grad_prop)
        # Log-dets are constant and cancel (LGC_mMALA_LV.m:120,129).
        log_q_fwd = -(0.5 / eps) * quad_fn(x_prop - mean_fwd)
        log_q_rev = -(0.5 / eps) * quad_fn(state.position - mean_rev)
        ratio = (logp_prop + log_q_rev) - (state.logp + log_q_fwd)

        divergent = ~(jnp.isfinite(ratio)
                      & jnp.all(jnp.isfinite(x_prop), axis=-1))
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        new_state = tree_where(
            accept, PMALAState(x_prop, logp_prop, grad_prop), state)
        return new_state, Info(accept_prob, accept, divergent)

    return Kernel(init, step)

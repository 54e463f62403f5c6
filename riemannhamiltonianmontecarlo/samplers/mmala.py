"""Manifold MALA (mMALA) and simplified mMALA.

Statistical contract from the reference MATLAB (``MCMC/BLR_mMALA.m``,
``MCMC/BLR_mMALA_Simp.m``):

* drift mean (``BLR_mMALA.m:231-233``)::

      mu(w) = w + eps/2 * G^{-1} grad
                - eps  * sum_d (G^{-1} dG_d G^{-1})[:, d]
                + eps/2 * G^{-1} [tr(G^{-1} dG_d)]_d

  (simplified mMALA keeps only the first term, ``BLR_mMALA_Simp.m:215-221``);
* proposal  N(mu(w), eps G(w)^{-1}), sampled via the Cholesky factor of
  ``eps G^{-1}`` (``BLR_mMALA.m:234``);
* asymmetric MH correction with
  ``log q = -sum log diag chol(eps G^{-1}) - (mu - x)^T G x / (2 eps)``
  (``BLR_mMALA.m:243,283``);
* the geometry of the *current* point is cached across iterations and
  only refreshed on accept (``BLR_mMALA.m:292-300``) -- here it lives in
  the state.

The curvature terms use the O(N D^2) contractions ``dg_dotted`` /
``dg_trace`` instead of the reference's dense (D, D, D) build
(``BLR_mMALA.m:200-215``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo import ops
from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel, metropolis_accept, tree_where

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class MMALAConfig:
    step_size: float = 1.0
    simplified: bool = False  # drop curvature terms (BLR_mMALA_Simp.m)
    jitter: float = 0.0


class MMALAState(NamedTuple):
    position: Array  # (C, D)
    logp: Array  # (C,)
    mean: Array  # (C, D) drift mean at the current position
    metric: Array  # (C, D, D) G(w)
    cov_factor: Array  # (C, D, D) UPPER-triangular A with A A^T = G^{-1} (= chol(G)^{-T}); NOT a lower Cholesky factor -- all consumers are factor-agnostic


def build(model, config: MMALAConfig = MMALAConfig()) -> Kernel:
    eps = config.step_size

    def geometry(w: Array):
        ms = model.manifold_state(w)
        g = ms.metric
        if config.jitter:
            g = g + config.jitter * jnp.eye(g.shape[-1], dtype=g.dtype)
        # One factorization per step: from L = chol(G), G^{-1} = L^{-T}L^{-1}
        # and L^{-T} is itself a factor of G^{-1} (L^{-T}L^{-T,T} = G^{-1}),
        # so the proposal-covariance "Cholesky" is the triangular inverse --
        # no second O(D^3) factorization of G^{-1} (the dominant saving at
        # LGC's D = 4096, where chol alone is ~D^3/3 work).  All
        # consumers (mvn_sample, the log-q diagonal) are factor-agnostic:
        # diag(L^{-T}) = 1/diag(L) gives the same half log-det.
        chol_g = ops.cholesky(g)
        linv = ops.solve_lower_triangular(
            chol_g, jnp.broadcast_to(jnp.eye(g.shape[-1], dtype=g.dtype), g.shape)
        )
        cov_factor = jnp.swapaxes(linv, -1, -2)
        first = ops.cho_solve(chol_g, ms.grad)
        mean = w + 0.5 * eps * first
        if not config.simplified:
            inv_g = jnp.matmul(cov_factor, linv, precision=_PREC)
            second = model.dg_dotted(w, inv_g, cache=ms.cache)
            trace_vec = model.dg_trace(w, inv_g, cache=ms.cache)
            third = ops.cho_solve(chol_g, trace_vec)
            mean = mean - eps * second + 0.5 * eps * third
        return ms.logp, mean, g, cov_factor

    def log_q(mean: Array, x: Array, g: Array, cov_factor: Array) -> Array:
        """log N(x; mean, eps G^{-1}) up to the 2 pi constant."""
        delta = mean - x
        quad = jnp.einsum("...a,...ab,...b->...", delta, g, delta, precision=_PREC) / eps
        d = x.shape[-1]
        half_logdet = jnp.sum(
            jnp.log(jnp.diagonal(cov_factor, axis1=-2, axis2=-1)), axis=-1
        ) + 0.5 * d * jnp.log(eps)
        return -half_logdet - 0.5 * quad

    def init(position: Array) -> MMALAState:
        logp, mean, g, cov_factor = geometry(position)
        return MMALAState(position, logp, mean, g, cov_factor)

    def step(key: Array, state: MMALAState) -> tuple[MMALAState, Info]:
        k_prop, k_acc = jax.random.split(key)
        noise = ops.mvn_sample(k_prop, state.cov_factor) * jnp.sqrt(
            jnp.asarray(eps, state.position.dtype)
        )
        w_new = state.mean + noise

        logp_new, mean_new, g_new, cov_factor_new = geometry(w_new)

        log_q_fwd = log_q(state.mean, w_new, state.metric, state.cov_factor)
        log_q_rev = log_q(mean_new, state.position, g_new, cov_factor_new)

        ratio = logp_new + log_q_rev - state.logp - log_q_fwd
        divergent = ~(jnp.isfinite(ratio) & jnp.all(jnp.isfinite(w_new), axis=-1))
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        new_state = tree_where(
            accept,
            MMALAState(w_new, logp_new, mean_new, g_new, cov_factor_new),
            state,
        )
        return new_state, Info(accept_prob, accept, divergent)

    return Kernel(init, step)

"""HMC with a constant dense preconditioner (constant-metric RMHMC).

The LGC latent-field sampler of the reference is RMHMC whose Fisher
metric is frozen at the prior mean (``LGC_RMHMC_LV.m:95-101``): the
generalized leapfrog degenerates to plain leapfrog with a constant dense
mass matrix G, momentum ~ N(0, G), position updates through G^{-1}, and
all log-det/trace terms cancel (``:154-196``).  This kernel implements
exactly that, generically: supply any (chol(G), G^{-1}) pair -- the
identity recovers standard HMC, `LGCModel.metric_chol/metric_inv`
recovers the reference LGC sampler (L = 30, eps = 0.1, ``:32-33``).

The two dense ops per leapfrog step are (C, D) x (D, D) matmuls; for
D = 4096 and hundreds of chains they are the dominant cost.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel, metropolis_accept, tree_where

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class PHMCConfig:
    step_size: float = 0.1  # LGC_RMHMC_LV.m:33
    num_leapfrog: int = 30  # LGC_RMHMC_LV.m:32
    randomize_length: bool = True
    random_direction: bool = True  # LGC_RMHMC_LV.m:144
    # Matmul precision INSIDE the leapfrog trajectory only.  The MH test
    # makes the integrator a proposal: endpoint Hamiltonians (logp and
    # kinetic energy) always run at HIGHEST, so reduced trajectory
    # precision can only move the acceptance rate, never bias the
    # stationary distribution.  On an NVIDIA GPU, "default" and "high"
    # run f32 matmuls in TF32 (about three decimal digits) and "highest"
    # in full f32.  Whether TF32 trajectories keep the acceptance rate at
    # large ill-conditioned D (LGC, D=4096) is not measured; monitor
    # acceptance.
    trajectory_precision: str = "highest"  # highest | high | default


class PHMCState(NamedTuple):
    position: Array  # (C, D)
    logp: Array  # (C,)


def build(model, mass_chol: Array, mass_inv: Array, config: PHMCConfig = PHMCConfig()) -> Kernel:
    """``mass_chol``: lower Cholesky of G (D, D); ``mass_inv``: G^{-1}."""
    eps = config.step_size
    max_steps = config.num_leapfrog
    traj_prec = {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
        "default": jax.lax.Precision.DEFAULT,
    }[config.trajectory_precision]
    # In-trajectory gradient: a model may expose a reduced-precision
    # variant (e.g. LGCModel.logp_and_grad_fast); endpoints stay exact.
    if config.trajectory_precision == "highest":
        traj_grad = model.logp_and_grad
    else:
        traj_grad = getattr(model, "logp_and_grad_fast", model.logp_and_grad)

    def init(position: Array) -> PHMCState:
        return PHMCState(position, model.logp(position))

    def kinetic(p: Array) -> Array:
        return 0.5 * jnp.einsum("...a,ab,...b->...", p, mass_inv, p, precision=_PREC)

    def step(key: Array, state: PHMCState) -> tuple[PHMCState, Info]:
        c = state.position.shape[0]
        k_mom, k_len, k_dir, k_acc = jax.random.split(key, 4)

        z = jax.random.normal(k_mom, state.position.shape, state.position.dtype)
        p0 = jnp.matmul(z, mass_chol.T, precision=_PREC)  # N(0, G)

        if config.randomize_length:
            u = jax.random.uniform(k_len, (c,))
            n_steps = jnp.ceil(u * max_steps).astype(jnp.int32)
        else:
            n_steps = jnp.full((c,), max_steps, jnp.int32)
        if config.random_direction:
            direction = jnp.where(jax.random.bernoulli(k_dir, 0.5, (c,)), 1.0, -1.0)
        else:
            direction = jnp.ones((c,))
        dt = (direction * eps)[:, None].astype(state.position.dtype)

        logp0 = model.logp(state.position)  # endpoint: always exact
        _, grad0 = traj_grad(state.position)

        def body(i, carry):
            w, p, g = carry
            active = (i < n_steps)[:, None]
            p_half = p + 0.5 * dt * g
            w_new = w + dt * jnp.matmul(p_half, mass_inv, precision=traj_prec)
            _, g_new = traj_grad(w_new)
            p_new = p_half + 0.5 * dt * g_new
            w = jnp.where(active, w_new, w)
            p = jnp.where(active, p_new, p)
            g = jnp.where(active, g_new, g)
            return (w, p, g)

        w_prop, p_prop, _ = jax.lax.fori_loop(
            0, max_steps, body, (state.position, p0, grad0)
        )

        logp_prop = model.logp(w_prop)
        ratio = (logp_prop - kinetic(p_prop)) - (logp0 - kinetic(p0))
        divergent = ~(jnp.isfinite(ratio) & jnp.all(jnp.isfinite(w_prop), axis=-1))
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        new_state = tree_where(accept, PHMCState(w_prop, logp_prop), state)
        return new_state, Info(accept_prob, accept, divergent)

    return Kernel(init, step)

"""Standard HMC with identity mass and randomized trajectory length.

Statistical contract from the reference (``code/hmc.py:12-99``):

* identity mass matrix (``hmc.py:21``), momentum ~ N(0, I);
* per-iteration trajectory length ``ceil(U * L)`` with L = 100, step size
  eps = 0.14 (``hmc.py:12,48``);
* explicit leapfrog with the model gradient (``hmc.py:51-62``);
* MH accept on the Hamiltonian difference (``hmc.py:69-80``);
* NaN trajectory guard (``hmc.py:56-57``) -> masked per-chain rejection.

Batching: every chain picks its own random trajectory length, so the
batch runs the *maximum* L leapfrog steps inside a ``lax.fori_loop`` and
chains that finished earlier carry their frozen state forward via a mask
(uniform lockstep work; no dynamic shapes).  Set
``randomize_length=False`` to run exactly L steps for all chains.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel, metropolis_accept, tree_where

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    step_size: float = 0.14  # reference default, code/hmc.py:12
    num_leapfrog: int = 100  # reference default, code/hmc.py:12
    randomize_length: bool = True  # ceil(U * L) steps per chain, code/hmc.py:48


class HMCState(NamedTuple):
    position: Array  # (C, D)
    logp: Array  # (C,)


def build(model, config: HMCConfig = HMCConfig()) -> Kernel:
    eps = config.step_size
    max_steps = config.num_leapfrog

    def init(position: Array) -> HMCState:
        return HMCState(position, model.logp(position))

    def step(key: Array, state: HMCState) -> tuple[HMCState, Info]:
        c = state.position.shape[0]
        k_mom, k_len, k_acc = jax.random.split(key, 3)

        p0 = jax.random.normal(k_mom, state.position.shape, dtype=state.position.dtype)
        if config.randomize_length:
            u = jax.random.uniform(k_len, (c,))
            n_steps = jnp.ceil(u * max_steps).astype(jnp.int32)  # in {1..L}
        else:
            n_steps = jnp.full((c,), max_steps, dtype=jnp.int32)

        def leapfrog_body(i, carry):
            w, p = carry
            active = (i < n_steps)[:, None]
            g = model.grad(w)
            p_half = p + 0.5 * eps * g
            w_new = w + eps * p_half
            p_new = p_half + 0.5 * eps * model.grad(w_new)
            w = jnp.where(active, w_new, w)
            p = jnp.where(active, p_new, p)
            return (w, p)

        w_prop, p_prop = jax.lax.fori_loop(
            0, max_steps, leapfrog_body, (state.position, p0)
        )

        logp_prop = model.logp(w_prop)
        h_prop = -logp_prop + 0.5 * jnp.sum(p_prop * p_prop, axis=-1)
        h_cur = -state.logp + 0.5 * jnp.sum(p0 * p0, axis=-1)
        ratio = h_cur - h_prop

        divergent = ~(
            jnp.isfinite(ratio)
            & jnp.all(jnp.isfinite(w_prop), axis=-1)
            & jnp.all(jnp.isfinite(p_prop), axis=-1)
        )
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)

        new_state = tree_where(
            accept, HMCState(w_prop, logp_prop), state
        )
        return new_state, Info(accept_prob, accept, divergent)

    return Kernel(init, step)

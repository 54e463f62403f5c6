"""Component-wise adaptive random-walk Metropolis-Hastings.

Statistical contract from the reference ``AMH`` (``code/metropolis.py:14-95``):

* one sweep = a Gaussian proposal on each coordinate in turn, each
  accepted/rejected on the full joint density (``metropolis.py:42-59``);
* per-coordinate proposal SD, adapted every 100 iterations during burn-in:
  x1.2 if window acceptance rate > 0.5, x0.8 if < 0.2
  (``metropolis.py:66-78``);
* defaults: 10000 iterations / 5000 burn-in, SD init 1.

Batching: chains are batched on the leading axis; the coordinate sweep
is a ``lax.scan`` over the static coordinate index (the sweep is
inherently sequential -- each coordinate's accept changes the state seen
by the next -- exactly as in the reference).  Each chain adapts its own
per-coordinate SDs; window bookkeeping lives in the state so the step
stays a pure function.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class AMHConfig:
    init_proposal_sd: float = 1.0  # code/metropolis.py:23
    adapt_interval: int = 100  # code/metropolis.py:66
    adapt_until: int = 5000  # reference BurnIn, code/metropolis.py:14
    grow: float = 1.2  # code/metropolis.py:76
    shrink: float = 0.8  # code/metropolis.py:78
    hi_rate: float = 0.5  # code/metropolis.py:75
    lo_rate: float = 0.2  # code/metropolis.py:77


class AMHState(NamedTuple):
    position: Array  # (C, D)
    logp: Array  # (C,)
    proposal_sd: Array  # (C, D)
    window_accepts: Array  # (C, D) accepted count since last adaptation pulse
    window_sweeps: Array  # () sweeps since last adaptation pulse
    iteration: Array  # () total sweeps done


def build(model, config: AMHConfig = AMHConfig()) -> Kernel:
    def init(position: Array) -> AMHState:
        c, d = position.shape
        return AMHState(
            position=position,
            logp=model.logp(position),
            proposal_sd=jnp.full((c, d), config.init_proposal_sd, position.dtype),
            window_accepts=jnp.zeros((c, d), position.dtype),
            window_sweeps=jnp.zeros((), jnp.int32),
            iteration=jnp.zeros((), jnp.int32),
        )

    def step(key: Array, state: AMHState) -> tuple[AMHState, Info]:
        c, d = state.position.shape
        eye = jnp.eye(d, dtype=state.position.dtype)

        def sweep_coord(carry, inp):
            w, logp, acc_counts, acc_prob_sum = carry
            coord, k = inp
            k_prop, k_acc = jax.random.split(k)
            delta = (
                jax.random.normal(k_prop, (c,), dtype=w.dtype)
                * state.proposal_sd[:, coord]
            )
            w_new = w + delta[:, None] * eye[coord]
            logp_new = model.logp(w_new)
            ratio = logp_new - logp
            u = jax.random.uniform(k_acc, (c,), dtype=w.dtype)
            ok = jnp.isfinite(ratio)
            accept = ok & (ratio > jnp.log(u))
            w = jnp.where(accept[:, None], w_new, w)
            logp = jnp.where(accept, logp_new, logp)
            acc_counts = acc_counts + eye[coord] * accept[:, None]
            acc_prob_sum = acc_prob_sum + jnp.where(
                ok, jnp.exp(jnp.minimum(ratio, 0.0)), 0.0
            )
            return (w, logp, acc_counts, acc_prob_sum), None

        coords = jnp.arange(d)
        keys = jax.random.split(key, d)
        (w, logp, acc_counts, acc_prob_sum), _ = jax.lax.scan(
            sweep_coord,
            (
                state.position,
                state.logp,
                state.window_accepts,
                jnp.zeros((c,), state.position.dtype),
            ),
            (coords, keys),
        )

        sweeps = state.window_sweeps + 1
        iteration = state.iteration + 1
        # Fraction of coordinate moves taken this sweep (before window reset).
        frac_accepted = jnp.sum(acc_counts - state.window_accepts, axis=-1) / d

        # Adaptation pulse (reference: every 100 iters while in burn-in,
        # code/metropolis.py:66-78; counters reset each window).
        pulse = (iteration % config.adapt_interval == 0) & (
            iteration < config.adapt_until
        )
        rate = acc_counts / jnp.maximum(sweeps, 1).astype(acc_counts.dtype)
        factor = jnp.where(
            rate > config.hi_rate,
            config.grow,
            jnp.where(rate < config.lo_rate, config.shrink, 1.0),
        ).astype(state.proposal_sd.dtype)
        sd = jnp.where(pulse, state.proposal_sd * factor, state.proposal_sd)
        acc_counts = jnp.where(pulse, jnp.zeros_like(acc_counts), acc_counts)
        sweeps = jnp.where(pulse, 0, sweeps)

        new_state = AMHState(w, logp, sd, acc_counts, sweeps, iteration)
        mean_rate = acc_prob_sum / d
        divergent = jnp.zeros((c,), bool)
        return new_state, Info(mean_rate, frac_accepted, divergent)

    return Kernel(init, step)

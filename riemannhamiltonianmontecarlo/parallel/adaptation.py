"""Dual-averaging step-size adaptation with cross-chain consensus.

The reference adapts per-coordinate proposal SDs with a window-multiplier
scheme (``code/metropolis.py:66-78``) and hand-tunes HMC/RMHMC step sizes
per dataset (MATLAB switch blocks).  BASELINE.json instead requires
Nesterov dual averaging (Hoffman & Gelman 2014, sec 3.2) driven by the
*pooled* acceptance statistic of every chain on the mesh -- thousands of
chains give a near-noiseless per-step acceptance estimate, so the step
size converges in tens of iterations rather than hundreds.

Mechanics: the wrapped kernel is rebuilt each traced step with the
current (traced) step size via ``dataclasses.replace(config,
step_size=eps)`` -- configs are plain frozen dataclasses whose step size
is only ever *used* inside traced arithmetic, so threading a tracer
through is sound.  After warmup, freeze at the averaged iterate
(``exp(log_eps_avg)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.parallel.collectives import cross_chain_mean
from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel

Array = jax.Array


class DualAveragingState(NamedTuple):
    log_eps: Array
    log_eps_avg: Array
    h_bar: Array
    mu: Array
    t: Array


def da_init(eps0: float) -> DualAveragingState:
    eps0 = jnp.asarray(eps0, jnp.float32)
    return DualAveragingState(
        log_eps=jnp.log(eps0),
        log_eps_avg=jnp.log(eps0),
        h_bar=jnp.zeros(()),
        mu=jnp.log(10.0 * eps0),
        t=jnp.zeros((), jnp.int32),
    )


def da_update(
    state: DualAveragingState,
    accept_rate: Array,
    target: float,
    *,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    t = state.t + 1
    tf = t.astype(jnp.float32)
    eta_h = 1.0 / (tf + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_rate)
    log_eps = state.mu - jnp.sqrt(tf) / gamma * h_bar
    eta = tf**-kappa
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_bar, state.mu, t)


class AdaptiveState(NamedTuple):
    inner: Any
    da: DualAveragingState

    @property
    def position(self):  # runner collection passthrough
        return self.inner.position


@dataclasses.dataclass(frozen=True)
class AdaptationConfig:
    target_accept: float = 0.8
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75


def adaptive(
    build_fn: Callable[..., Kernel],
    model,
    config,
    adapt: AdaptationConfig = AdaptationConfig(),
    axis_name: str | None = None,
) -> Kernel:
    """Wrap a step-size-bearing kernel with dual-averaging warmup.

    ``build_fn(model, config)`` must be a sampler ``build`` whose config
    carries ``step_size`` (hmc / rmhmc / mala / mmala).
    """

    def init(position: Array) -> AdaptiveState:
        inner = build_fn(model, config).init(position)
        return AdaptiveState(inner, da_init(config.step_size))

    def step(key: Array, state: AdaptiveState) -> tuple[AdaptiveState, Info]:
        eps = jnp.exp(state.da.log_eps)
        kernel = build_fn(model, dataclasses.replace(config, step_size=eps))
        inner, info = kernel.step(key, state.inner)
        accept = cross_chain_mean(info.accept_prob, axis_name)
        da = da_update(
            state.da,
            accept,
            adapt.target_accept,
            gamma=adapt.gamma,
            t0=adapt.t0,
            kappa=adapt.kappa,
        )
        return AdaptiveState(inner, da), info

    return Kernel(init, step)


def frozen_step_size(state: AdaptiveState) -> float:
    """The dual-averaged step size after warmup (host scalar)."""
    return float(jnp.exp(state.da.log_eps_avg))


def run_adaptive(
    build_fn: Callable[..., Kernel],
    model,
    config,
    key: Array,
    init_position: Array,
    *,
    num_samples: int,
    warmup: int,
    adapt: AdaptationConfig = AdaptationConfig(),
    mesh=None,
    **run_kwargs,
):
    """Dual-averaging warmup, then sampling at the frozen step size.

    Returns (RunResult, eps) where eps is the adapted step size.
    """
    from riemannhamiltonianmontecarlo.parallel.runner import run

    k_warm, k_sample = jax.random.split(key)
    warm_kernel = adaptive(build_fn, model, config, adapt)
    warm = run(
        warm_kernel,
        k_warm,
        init_position,
        num_samples=warmup,
        burn_in=0,
        collect=False,
        mesh=mesh,
    )
    eps = frozen_step_size(warm.final_state)
    kernel = build_fn(model, dataclasses.replace(config, step_size=eps))
    res = run(
        kernel,
        k_sample,
        None,
        num_samples=num_samples,
        burn_in=0,
        init_state=warm.final_state.inner,
        mesh=mesh,
        **run_kwargs,
    )
    return res, eps

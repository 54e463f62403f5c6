"""Progress monitoring: windowed acceptance prints + profiling helpers.

The reference prints windowed acceptance rates every 50-1000 iterations
and resets the window (``code/hmc.py:85-89``, ``code/rmhmc.py:39-45``,
``StochVol_RMHMC.m:448-462``).  :func:`monitor` reproduces that as a
kernel wrapper using ``jax.debug.print`` (host callback, safe under scan
and sharding); :func:`profile_trace` wraps a run in a ``jax.profiler``
trace for TensorBoard-style inspection (SURVEY.md section 5, tracing).
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel

Array = jax.Array


class MonitorState(NamedTuple):
    inner: Any
    accept_sum: Array  # () window sum of mean accept prob
    divergence_sum: Array  # () window divergence count
    count: Array  # () steps in window
    step: Array  # () total steps

    @property
    def position(self) -> Array:  # runner collection passthrough
        return self.inner.position


def monitor(kernel: Kernel, every: int = 50, label: str = "mcmc") -> Kernel:
    """Wrap a kernel to print windowed acceptance / divergences."""

    def init(position: Array) -> MonitorState:
        return MonitorState(
            kernel.init(position),
            jnp.zeros(()),
            jnp.zeros(()),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32),
        )

    def step(key: Array, state: MonitorState) -> tuple[MonitorState, Info]:
        inner, info = kernel.step(key, state.inner)
        acc = state.accept_sum + jnp.mean(info.accept_prob)
        div = state.divergence_sum + jnp.sum(info.divergent)
        count = state.count + 1
        step_no = state.step + 1
        pulse = step_no % every == 0

        def report(args):
            s, a, c, d = args
            jax.debug.print(
                "[" + label + "] step {s}: window accept {a:.3f}, divergences {d}",
                s=s,
                a=a / jnp.maximum(c, 1),
                d=d,
            )
            return 0

        jax.lax.cond(pulse, report, lambda _: 0, (step_no, acc, count.astype(acc.dtype), div))
        acc = jnp.where(pulse, 0.0, acc)
        div = jnp.where(pulse, 0.0, div)
        count = jnp.where(pulse, 0, count)
        return MonitorState(inner, acc, div, count, step_no), info

    return Kernel(init, step)


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/rhmc_profile"):
    """jax.profiler trace around a sampling run (inspect with xprof/TB)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()

"""Chain runner: warmup + sampling scans over a (possibly sharded) batch.

Replaces the reference's per-sampler Python iteration loops
(``code/hmc.py:38``, ``code/rmhmc.py:37``, driver loop ``code/main.py:48``)
with a single jitted ``lax.scan`` advancing all chains per step.  The
burn-in / sampling split mirrors the reference convention of timing only
the post-burn-in phase (``code/hmc.py:92-96``) -- ``run`` compiles the two
phases into one program; ``bench.py`` times the sampling phase alone.

Sharding: pass a 1-D mesh and the initial position's chain axis is
sharded across devices.  All kernel math is chain-batched, so GSPMD
partitions the whole scan without communication (JAX's partitionable
threefry keeps shaped PRNG draws consistent across mesh sizes).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from riemannhamiltonianmontecarlo.parallel.mesh import chain_sharding, shard_chains
from riemannhamiltonianmontecarlo.samplers.base import Kernel

Array = jax.Array


@dataclasses.dataclass
class RunResult:
    samples: Array | None  # (C, S, D) post-burn-in positions (thinned)
    final_state: Any
    accept_rate: Array  # () mean accept probability over the sampling phase
    divergences: Array  # () total divergent transitions in the sampling phase
    warmup_accept_rate: Array  # () mean accept probability during warmup


def _position_of(state) -> Array:
    return state.position


@partial(jax.jit, static_argnames=("step", "num_steps", "collect", "collect_fn"))
def _scan_phase(step, key, state, num_steps: int, collect: bool, collect_fn=None):
    keys = jax.random.split(key, num_steps)

    def body(st, k):
        st, info = step(k, st)
        out = (collect_fn or _position_of)(st) if collect else None
        stats = (jnp.mean(info.accept_prob), jnp.sum(info.divergent))
        return st, (out, stats)

    state, (positions, stats) = jax.lax.scan(body, state, keys)
    accept = jnp.mean(stats[0])
    div = jnp.sum(stats[1])
    if collect:
        return state, positions, accept, div
    return state, accept, div


def run(
    kernel: Kernel,
    key: Array,
    init_position: Array,
    *,
    num_samples: int,
    burn_in: int = 0,
    thin: int = 1,
    mesh: Mesh | None = None,
    collect: bool = True,
    warmup_kernel: Kernel | None = None,
    init_state=None,
    collect_fn=None,
) -> RunResult:
    """Run ``burn_in`` warmup steps then collect ``num_samples`` samples.

    init_position: (C, D).  Returns samples as (C, num_samples // thin, D).
    ``warmup_kernel`` (same state type) replaces ``kernel`` during burn-in
    -- e.g. MALA's transient-scaling phase (``BLR_MALA.m:167,243``).
    ``collect_fn`` maps the kernel state to the pytree recorded each step
    (default: ``state.position``) -- e.g. both hyperparameters and latent
    volatilities of the StochVol two-block state.
    """
    if init_state is not None:
        state = init_state  # continue from a previous run's final_state
    else:
        if mesh is not None:
            init_position = shard_chains(mesh, init_position)
        state = (warmup_kernel or kernel).init(init_position)
        if mesh is not None:
            state = shard_chains(mesh, state)
    k_warm, k_sample = jax.random.split(key)

    warm_accept = jnp.zeros(())
    if burn_in > 0:
        warm_step = (warmup_kernel or kernel).step
        state, warm_accept, _ = _scan_phase(warm_step, k_warm, state, burn_in, False)

    if collect:
        state, positions, accept, div = _scan_phase(
            kernel.step, k_sample, state, num_samples, True, collect_fn
        )

        # (S, C, D) -> (C, S, D); thinning keeps a static subset.
        def _to_samples(pos):
            s = jnp.moveaxis(pos, 0, 1)
            if thin > 1:
                s = s[:, (thin - 1) :: thin]
            if mesh is not None:
                s = jax.lax.with_sharding_constraint(s, chain_sharding(mesh, s.ndim))
            return s

        samples = jax.tree.map(_to_samples, positions)
    else:
        state, accept, div = _scan_phase(kernel.step, k_sample, state, num_samples, False)
        samples = None

    return RunResult(
        samples=samples,
        final_state=state,
        accept_rate=accept,
        divergences=div,
        warmup_accept_rate=warm_accept,
    )


def run_checkpointed(
    kernel: Kernel,
    key: Array,
    init_position: Array,
    *,
    num_samples: int,
    checkpoint_path,
    burn_in: int = 0,
    checkpoint_every: int = 500,
    mesh: Mesh | None = None,
    collect_fn=None,
    warmup_kernel: Kernel | None = None,
    _stop_after_segments: int | None = None,
) -> RunResult:
    """``run`` in ``checkpoint_every``-step segments with resume.

    After each segment the kernel state is checkpointed atomically
    (``utils.checkpoint.save_state``; per-process shards in multi-process
    runs) and the segment's samples are persisted to
    ``<checkpoint_path>.seg<i>``, so a killed run restarts from the last
    completed segment instead of step 0 -- the subsystem the reference
    lacks entirely (its ``.mat`` dumps are end-of-run only,
    ``BLR_RMHMC.m:406``).  Per-segment PRNG keys are ``fold_in(key, i)``,
    so interrupted-and-resumed runs are bit-identical to uninterrupted
    ones.  ``_stop_after_segments`` simulates a crash (tests only).
    """
    from pathlib import Path

    from riemannhamiltonianmontecarlo.utils import checkpoint as ckpt

    path = Path(checkpoint_path)
    n_seg = -(-num_samples // checkpoint_every)
    sizes = [checkpoint_every] * (n_seg - 1)
    sizes.append(num_samples - checkpoint_every * (n_seg - 1))

    if ckpt.checkpoint_exists(path):
        pos = init_position if mesh is None else shard_chains(mesh, init_position)
        template = (warmup_kernel or kernel).init(pos)
        state, start_seg, _ = ckpt.load_state(path, template)
        warm_accept = jnp.zeros(())
    else:
        warm = run(
            kernel,
            jax.random.fold_in(key, 0),
            init_position,
            num_samples=max(burn_in, 1),
            collect=False,
            mesh=mesh,
            warmup_kernel=warmup_kernel,
        )
        state, start_seg, warm_accept = warm.final_state, 0, warm.warmup_accept_rate
        ckpt.save_state(path, state, step=0)

    accepts, divs = [], []
    for i in range(start_seg, n_seg):
        if _stop_after_segments is not None and i - start_seg >= _stop_after_segments:
            break
        res = run(
            kernel,
            jax.random.fold_in(key, i + 1),
            None,
            num_samples=sizes[i],
            init_state=state,
            mesh=mesh,
            collect_fn=collect_fn,
        )
        state = res.final_state
        accepts.append(float(res.accept_rate) * sizes[i])
        divs.append(int(res.divergences))
        ckpt.save_state(path.with_name(path.name + f".seg{i}"), res.samples, step=i)
        ckpt.save_state(path, state, step=i + 1)

    # Reassemble all persisted segments (including pre-crash ones) in order,
    # stopping at the first gap.
    import numpy as np

    flat_parts = []
    for i in range(n_seg):
        f = path.with_name(path.name + f".seg{i}")
        if not ckpt.checkpoint_exists(f):
            break
        with np.load(ckpt._shard_path(f)) as d:
            n_leaves = sum(1 for k in d.files if k.startswith("leaf_"))
            flat_parts.append([d[f"leaf_{j}"] for j in range(n_leaves)])
    if flat_parts:
        merged = [
            jnp.concatenate([jnp.asarray(p[j]) for p in flat_parts], axis=1)
            for j in range(len(flat_parts[0]))
        ]
        # Rebuild the collect_fn pytree structure from a one-step probe.
        probe = (collect_fn or _position_of)(state)
        treedef = jax.tree.structure(probe)
        samples = jax.tree.unflatten(treedef, merged)
    else:
        samples = None

    total = sum(sizes[start_seg : start_seg + len(accepts)]) or 1
    return RunResult(
        samples=samples,
        final_state=state,
        accept_rate=jnp.asarray(sum(accepts) / total),
        divergences=jnp.asarray(sum(divs)),
        warmup_accept_rate=warm_accept,
    )

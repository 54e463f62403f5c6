"""Riemann-manifold HMC with the generalized (implicit) leapfrog.

Statistical contract from the reference (``code/rmhmc.py:13-201`` /
MATLAB ``BLR_RMHMC.m:222-376``):

* momentum ~ N(0, G(w))  (MATLAB contract; the Python port's
  ``randn @ lower-chol`` at ``code/rmhmc.py:80`` has covariance L^T L --
  a port bug this framework does not reproduce, see ``ops.mvn_sample``);
* randomized trajectory length ``ceil(U * L)`` and random direction sign
  (``code/rmhmc.py:89-93``; the port draws the sign from ``randn > 0.5``
  giving P(+1) = 0.31 -- statistically irrelevant for a reversible
  integrator, here a fair coin);
* generalized leapfrog: fixed-point iteration (``num_fixed_point`` = 4
  Newton steps, ``code/rmhmc.py:103,115``) on the implicit momentum
  half-step and on the implicit position step with G recomputed inside
  the loop, then an explicit momentum half-step with fresh geometry
  (``code/rmhmc.py:96-163``);
* H = -log pi(w) + 1/2 log|G| + 1/2 p^T G^{-1} p, log-det via the
  Cholesky diagonal (``code/rmhmc.py:171-176``); MH accept on dH.

Redesign for chain batching:

* the reference builds the dense (D, D, D) tensor ``G^{-1} dG_d`` per
  step; here the momentum updates consume only the contractions
  ``tr(G^{-1} dG_d)`` and ``u^T dG_d u`` which the model supplies in
  O(N D^2) (see ``models/logreg.py``);
* fixed iteration counts map to unrolled loops -- no data-dependent
  control flow under ``lax.fori_loop``;
* per-chain random trajectory lengths run the max-L loop with a lockstep
  active mask;
* all linear algebra is the chain-batched unrolled Cholesky/solve from
  ``ops.linalg`` (vectorized across chains);
* divergences (non-finite anywhere) mask to a rejection instead of the
  reference's print-and-renormalize hacks (``code/rmhmc.py:81-85,
  125-130``), which are ad-hoc additions absent from the MATLAB oracle.
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
class RMHMCConfig:
    step_size: float = 0.5  # code/rmhmc.py:13
    num_leapfrog: int = 6  # code/rmhmc.py:13
    num_fixed_point: int = 4  # NumOfNewtonSteps, code/rmhmc.py:13
    randomize_length: bool = True  # ceil(U*L), code/rmhmc.py:89
    random_direction: bool = True  # time-reversal sign, code/rmhmc.py:90-93
    jitter: float = 0.0  # optional diagonal jitter on G for f32 stability
    # Heavy-tailed momentum variant (``MCMC/BLR_RMHMC_StudentT.m``):
    # momentum ~ multivariate-t_1(0, G) (``:265`` mvtrnd(G,1)), kinetic
    # energy ((1+D)/2) log(1 + p^T G^{-1} p) (``:386-392``), with the
    # matching (1+D)/2 / (1 + p^T G^{-1} p) weights in the leapfrog
    # forces (``:296,327``).
    student_t: bool = False
    # linalg backend for the per-iteration solves: None (auto), "unrolled",
    # "xla", "pallas" (chains-last fused Triton kernel, GPU only).
    linalg: str | None = None
    # Some reference configs use different fixed-point counts for the
    # momentum and position updates (LGC joint: 10 vs 3,
    # LGC_RMHMC_Paras_LV.m:43-44).  None = use num_fixed_point.
    num_fixed_point_momentum: int | None = None


class RMHMCState(NamedTuple):
    position: Array  # (C, D)
    logp: Array  # (C,)
    # Cached _Geometry at ``position`` (None = recompute lazily).  The
    # geometry of the accepted point is always known at the end of a step
    # (fresh on accept, carried on reject), so steady-state sampling never
    # rebuilds G/chol(G)/G^{-1} at the current point -- one of the ~L+1
    # geometry builds per step the reference pays (``code/rmhmc.py:50-60``
    # runs unconditionally every iteration).  Block-Gibbs users whose model
    # changes between calls (``samplers/stochvol.py``, ``lgc_joint.py``)
    # construct the state without a cache and take the lazy path.
    geo: object = None


class _Geometry(NamedTuple):
    """Carried per-position manifold quantities (all chain-batched)."""

    logp: Array
    grad: Array
    metric: Array
    cache: object  # model dG cache
    chol: Array
    inv: Array
    half_logdet: Array


def build(model, config: RMHMCConfig = RMHMCConfig()) -> Kernel:
    eps = config.step_size
    max_steps = config.num_leapfrog
    n_fp = config.num_fixed_point
    n_fp_mom = (
        config.num_fixed_point
        if config.num_fixed_point_momentum is None
        else config.num_fixed_point_momentum
    )

    def geometry(w: Array) -> _Geometry:
        ms = model.manifold_state(w)
        g = ms.metric
        if config.jitter:
            g = g + config.jitter * jnp.eye(g.shape[-1], dtype=g.dtype)
        l = ops.cholesky(g, method=config.linalg)
        inv = ops.inv_psd_from_chol(l)
        half_logdet = 0.5 * ops.logdet_from_chol(l)
        return _Geometry(ms.logp, ms.grad, g, ms.cache, l, inv, half_logdet)

    def hamiltonian(geo: _Geometry, p: Array) -> Array:
        quad = jnp.einsum(
            "...a,...ab,...b->...", p, geo.inv, p, precision=jax.lax.Precision.HIGHEST
        )
        if config.student_t:
            d = p.shape[-1]
            kinetic = 0.5 * (1.0 + d) * jnp.log1p(quad)
        else:
            kinetic = 0.5 * quad
        return -geo.logp + geo.half_logdet + kinetic

    def init(position: Array) -> RMHMCState:
        geo = geometry(position)
        return RMHMCState(position, geo.logp, geo)

    def step(key: Array, state: RMHMCState) -> tuple[RMHMCState, Info]:
        c = state.position.shape[0]
        k_mom, k_chi, k_len, k_dir, k_acc = jax.random.split(key, 5)

        geo0 = geometry(state.position) if state.geo is None else state.geo
        p0 = ops.mvn_sample(k_mom, geo0.chol)
        if config.student_t:
            # t_1(0, G) = N(0, G) / sqrt(chi^2_1)  (mvtrnd(G,1), StudentT.m:265)
            chi = jax.random.normal(k_chi, (c,), p0.dtype) ** 2
            p0 = p0 / jnp.sqrt(chi)[:, None]
        h_cur = hamiltonian(geo0, p0)

        if config.randomize_length:
            u = jax.random.uniform(k_len, (c,))
            n_steps = jnp.ceil(u * max_steps).astype(jnp.int32)
        else:
            n_steps = jnp.full((c,), max_steps, dtype=jnp.int32)
        if config.random_direction:
            direction = jnp.where(
                jax.random.bernoulli(k_dir, 0.5, (c,)), 1.0, -1.0
            ).astype(state.position.dtype)
        else:
            direction = jnp.ones((c,), state.position.dtype)
        dt = (direction * eps)[:, None]  # (C, 1), broadcast over D

        def force_base(w, geo: _Geometry):
            """grad - 1/2 tr(G^-1 dG_d): constant across the fixed point."""
            trace_vec = model.dg_trace(w, geo.inv, cache=geo.cache)
            return geo.grad - 0.5 * trace_vec

        def momentum_force(w, geo: _Geometry, pm, base):
            """dp/dt = base + weight * u^T dG_d u, u = G^-1 pm.

            weight = 1/2 (Gaussian momentum) or
            ((1+D)/2) / (1 + p^T G^{-1} p) (Student-t, StudentT.m:296).
            The O(N D^2) trace term is hoisted into ``base`` -- it does not
            depend on the momentum iterate, so the K fixed-point rounds
            only pay the cheap O(N D) bilinear contraction.
            """
            u_vec = jnp.einsum(
                "...ab,...b->...a", geo.inv, pm, precision=jax.lax.Precision.HIGHEST
            )
            bil = model.dg_bilinear(w, u_vec, u_vec, cache=geo.cache)
            if config.student_t:
                d = w.shape[-1]
                quad = jnp.sum(pm * u_vec, axis=-1, keepdims=True)
                last = 0.5 * (1.0 + d) * bil / (1.0 + quad)
            else:
                last = 0.5 * bil
            return base + last

        def leapfrog_body(i, carry):
            w, p, geo, bad = carry
            active = (i < n_steps)[:, None]

            # (a) implicit momentum half-step: fixed point on p'
            base = force_base(w, geo)
            pm = p
            for _ in range(n_fp_mom):
                pm = p + 0.5 * dt * momentum_force(w, geo, pm, base)

            # (b) implicit position step: fixed point on w', G recomputed
            # inside the loop (reference code/rmhmc.py:113-123).
            u0 = jnp.einsum(
                "...ab,...b->...a", geo.inv, pm, precision=jax.lax.Precision.HIGHEST
            )
            if config.student_t:
                d_dim = w.shape[-1]
                q0 = jnp.sum(pm * u0, axis=-1, keepdims=True)
                u0_eff = (1.0 + d_dim) * u0 / (1.0 + q0)  # StudentT.m:327
            else:
                u0_eff = u0
            wf = w
            for _ in range(n_fp):
                g_new = model.metric(wf)
                if config.jitter:
                    g_new = g_new + config.jitter * jnp.eye(g_new.shape[-1], dtype=g_new.dtype)
                u_new = ops.solve_psd(g_new, pm, method=config.linalg)
                if config.student_t:
                    qn = jnp.sum(pm * u_new, axis=-1, keepdims=True)
                    u_new = (1.0 + d_dim) * u_new / (1.0 + qn)
                wf = w + 0.5 * dt * (u0_eff + u_new)

            # (c) explicit momentum half-step with fresh geometry at w'.
            geo_new = geometry(wf)
            p_new = pm + 0.5 * dt * momentum_force(
                wf, geo_new, pm, force_base(wf, geo_new)
            )

            step_bad = ~(
                jnp.all(jnp.isfinite(wf), axis=-1)
                & jnp.all(jnp.isfinite(p_new), axis=-1)
            )
            ok = active[:, 0] & ~bad & ~step_bad
            w = jnp.where(ok[:, None], wf, w)
            p = jnp.where(ok[:, None], p_new, p)
            geo = tree_where(ok, geo_new, geo)
            bad = bad | (active[:, 0] & step_bad)
            return (w, p, geo, bad)

        w_prop, p_prop, geo_prop, bad = jax.lax.fori_loop(
            0,
            max_steps,
            leapfrog_body,
            (state.position, p0, geo0, jnp.zeros((c,), bool)),
        )

        h_prop = hamiltonian(geo_prop, p_prop)
        ratio = h_cur - h_prop
        divergent = bad | ~jnp.isfinite(ratio)
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)

        cur_state = RMHMCState(state.position, state.logp, geo0)
        new_state = tree_where(
            accept, RMHMCState(w_prop, geo_prop.logp, geo_prop), cur_state
        )
        return new_state, Info(accept_prob, accept, divergent)

    return Kernel(init, step)

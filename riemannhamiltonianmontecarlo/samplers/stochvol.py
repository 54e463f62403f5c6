"""Two-block Gibbs sampler for stochastic volatility (RMHMC-within-Gibbs).

Statistical contract from ``Stoch_Vol/RM-HMC/StochVol_RMHMC.m`` (SURVEY.md
3.5): each iteration alternates

1. **latent block** x | theta: HMC with the *constant* tridiagonal metric
   G = AR(1)-precision + I/2 -- leapfrog is exact/explicit
   (``:152-185``), L = 50, eps = 5/50 (``:66-68``); since G is constant
   within the block, the log-det terms cancel in the MH ratio;
2. **hyper block** theta = (beta, sigma, phi) | x: generalized-leapfrog
   RMHMC in the transformed coordinates (beta, log sigma, atanh phi)
   with the analytic 3x3 Fisher+prior metric, L = 6, eps = 3/6,
   5 fixed-point steps, 1e-6 jitter on the Cholesky (``:71-77,258``).
   Implemented by *reusing the generic RMHMC kernel* on the conditional
   manifold model ``StochVolModel.hyper_manifold(x)`` -- the payoff of
   splitting model from kernel (SURVEY.md section 7 design pivot).

Initialization per the reference: x = y, (beta, sigma, phi) = 0.5
(``StochVol_RMHMC.m:86-89``).

Batching: chains batched on the leading axis; tridiagonal solves in
the latent leapfrog use parallel cyclic reduction (``ops.tridiag``),
momentum sampling uses the scanned bidiagonal Cholesky once per step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.ops import tridiag
from riemannhamiltonianmontecarlo.samplers import rmhmc as rmhmc_mod
from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel, metropolis_accept

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class StochVolConfig:
    latent_num_leapfrog: int = 50  # StochVol_RMHMC.m:66
    latent_step_size: float = 0.1  # Dist/L = 5/50, :67-68
    hyper_num_leapfrog: int = 6  # :71
    hyper_step_size: float = 0.5  # HPDist/L = 3/6, :72-73
    hyper_num_fixed_point: int = 5  # :74
    hyper_jitter: float = 1e-6  # :258
    randomize_length: bool = True
    random_direction: bool = True
    # Comparator variants (paper Tables 8-9):
    #  - "rmhmc": tridiagonal-metric latents + RMHMC hypers (StochVol_RMHMC.m)
    #  - "hmc": identity-mass leapfrog both blocks (StochVol_HMC.m:57-67,
    #    defaults L=100, eps=0.03 latents / 0.015 hypers)
    #  - "mala": Langevin both blocks (StochVol_MALA.m:57-67)
    #  - "mmala": manifold MALA both blocks (StochVol_mMALA.m:66-72,
    #    eps = 0.07 latents / 1.0 hypers); the latent metric is constant
    #    in x, so the curvature drift terms vanish and the update is
    #    tridiagonally-preconditioned MALA
    method: str = "rmhmc"


class StochVolState(NamedTuple):
    position: Array  # (C, 3) constrained (beta, sigma, phi) -- what is collected
    theta: Array  # (C, 3) transformed coords (beta, log sigma, atanh phi)
    x: Array  # (C, T) latent volatilities


def build(model, config: StochVolConfig = StochVolConfig()) -> Kernel:
    hyper_cfg = rmhmc_mod.RMHMCConfig(
        step_size=config.hyper_step_size,
        num_leapfrog=config.hyper_num_leapfrog,
        num_fixed_point=config.hyper_num_fixed_point,
        randomize_length=config.randomize_length,
        random_direction=config.random_direction,
        jitter=config.hyper_jitter,
    )

    def init(position: Array) -> StochVolState:
        """position: (C, 3) constrained initial (beta, sigma, phi)."""
        c = position.shape[0]
        theta = model.unconstrain(position[:, 0], position[:, 1], position[:, 2])
        x = jnp.broadcast_to(model.y, (c, model.num_obs)).astype(position.dtype)
        return StochVolState(position, theta, x)

    def latent_update_mala(key: Array, x: Array, theta: Array):
        """Langevin proposal on the latent conditional (StochVol_MALA.m)."""
        k_prop, k_acc = jax.random.split(key)
        eps = config.latent_step_size
        g = model.latent_grad(x, theta)
        mean_fwd = x + 0.5 * eps * g
        x_new = mean_fwd + jnp.sqrt(eps) * jax.random.normal(k_prop, x.shape, x.dtype)
        g_new = model.latent_grad(x_new, theta)
        mean_rev = x_new + 0.5 * eps * g_new
        log_q_fwd = -0.5 * jnp.sum((x_new - mean_fwd) ** 2, axis=-1) / eps
        log_q_rev = -0.5 * jnp.sum((x - mean_rev) ** 2, axis=-1) / eps
        ratio = (
            model.latent_logp(x_new, theta)
            + log_q_rev
            - model.latent_logp(x, theta)
            - log_q_fwd
        )
        divergent = ~(jnp.isfinite(ratio) & jnp.all(jnp.isfinite(x_new), axis=-1))
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        return jnp.where(accept[:, None], x_new, x), accept, accept_prob, divergent

    def latent_update_mmala(key: Array, x: Array, theta: Array):
        """Tridiagonally-preconditioned MALA (StochVol_mMALA.m latents).

        G is constant in x so the mMALA curvature terms vanish:
        mean = x + eps/2 G^{-1} grad, cov = eps G^{-1}; the log-det
        contributions cancel between forward and reverse densities.
        """
        k_prop, k_acc = jax.random.split(key)
        eps = config.latent_step_size
        diag, off = model.latent_metric(theta)
        chol = tridiag.cholesky(diag, off)

        def drift(xc):
            g = model.latent_grad(xc, theta)
            return xc + 0.5 * eps * tridiag.solve(diag, off, g)

        mean_fwd = drift(x)
        z = jax.random.normal(k_prop, x.shape, x.dtype)
        # noise ~ N(0, eps G^{-1}): G^{-1} L z has covariance G^{-1}.
        noise = tridiag.solve(diag, off, tridiag.matvec_chol(chol, z))
        x_new = mean_fwd + jnp.sqrt(eps) * noise
        mean_rev = drift(x_new)

        def quad(delta):
            return jnp.sum(delta * tridiag.matvec(diag, off, delta), axis=-1)

        log_q_fwd = -0.5 * quad(x_new - mean_fwd) / eps
        log_q_rev = -0.5 * quad(x - mean_rev) / eps
        ratio = (
            model.latent_logp(x_new, theta)
            + log_q_rev
            - model.latent_logp(x, theta)
            - log_q_fwd
        )
        divergent = ~(jnp.isfinite(ratio) & jnp.all(jnp.isfinite(x_new), axis=-1))
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        return jnp.where(accept[:, None], x_new, x), accept, accept_prob, divergent

    def latent_update(key: Array, x: Array, theta: Array):
        if config.method == "mala":
            return latent_update_mala(key, x, theta)
        if config.method == "mmala":
            return latent_update_mmala(key, x, theta)
        c = x.shape[0]
        k_mom, k_len, k_dir, k_acc = jax.random.split(key, 4)
        if config.method == "rmhmc":
            diag, off = model.latent_metric(theta)
        else:  # "hmc": identity mass (StochVol_HMC.m)
            diag = jnp.ones_like(x)
            off = jnp.zeros(x.shape[:-1] + (x.shape[-1] - 1,), x.dtype)
        chol = tridiag.cholesky(diag, off)
        z = jax.random.normal(k_mom, x.shape, x.dtype)
        p0 = tridiag.matvec_chol(chol, z)

        if config.randomize_length:
            u = jax.random.uniform(k_len, (c,))
            n_steps = jnp.ceil(u * config.latent_num_leapfrog).astype(jnp.int32)
        else:
            n_steps = jnp.full((c,), config.latent_num_leapfrog, jnp.int32)
        if config.random_direction:
            direction = jnp.where(jax.random.bernoulli(k_dir, 0.5, (c,)), 1.0, -1.0)
        else:
            direction = jnp.ones((c,))
        dt = (direction * config.latent_step_size)[:, None].astype(x.dtype)

        logp0 = model.latent_logp(x, theta)
        grad0 = model.latent_grad(x, theta)

        def body(i, carry):
            xc, pc, gc = carry
            active = (i < n_steps)[:, None]
            p_half = pc + 0.5 * dt * gc
            x_new = xc + dt * tridiag.solve(diag, off, p_half)
            g_new = model.latent_grad(x_new, theta)
            p_new = p_half + 0.5 * dt * g_new
            xc = jnp.where(active, x_new, xc)
            pc = jnp.where(active, p_new, pc)
            gc = jnp.where(active, g_new, gc)
            return (xc, pc, gc)

        x_prop, p_prop, _ = jax.lax.fori_loop(
            0, config.latent_num_leapfrog, body, (x, p0, grad0)
        )

        # Constant G within the update: log-det cancels in the ratio.
        def kinetic(p):
            return 0.5 * jnp.sum(p * tridiag.solve(diag, off, p), axis=-1)

        logp_prop = model.latent_logp(x_prop, theta)
        ratio = (logp_prop - kinetic(p_prop)) - (logp0 - kinetic(p0))
        divergent = ~(jnp.isfinite(ratio) & jnp.all(jnp.isfinite(x_prop), axis=-1))
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        x_out = jnp.where(accept[:, None], x_prop, x)
        return x_out, accept, accept_prob, divergent

    def step(key: Array, state: StochVolState) -> tuple[StochVolState, Info]:
        k_latent, k_hyper = jax.random.split(key)

        # Block 1: latents.
        x, lat_acc, lat_prob, lat_div = latent_update(k_latent, state.x, state.theta)

        # Block 2: hyperparameters via a generic kernel on the conditional
        # manifold model (method-selected comparator, Tables 8-9).
        hyper_model = model.hyper_manifold(x)
        if config.method == "rmhmc":
            hyper_kernel = rmhmc_mod.build(hyper_model, hyper_cfg)
            h_state = rmhmc_mod.RMHMCState(state.theta, hyper_model.logp(state.theta))
        elif config.method == "hmc":
            from riemannhamiltonianmontecarlo.samplers import hmc as hmc_mod

            hyper_kernel = hmc_mod.build(
                hyper_model,
                hmc_mod.HMCConfig(
                    step_size=config.hyper_step_size,
                    num_leapfrog=config.hyper_num_leapfrog,
                    randomize_length=config.randomize_length,
                ),
            )
            h_state = hmc_mod.HMCState(state.theta, hyper_model.logp(state.theta))
        elif config.method == "mala":
            from riemannhamiltonianmontecarlo.samplers import mala as mala_mod

            hyper_kernel = mala_mod.build(
                hyper_model, mala_mod.MALAConfig(step_size=config.hyper_step_size)
            )
            h_state = hyper_kernel.init(state.theta)
        elif config.method == "mmala":
            from riemannhamiltonianmontecarlo.samplers import mmala as mmala_mod

            hyper_kernel = mmala_mod.build(
                hyper_model,
                mmala_mod.MMALAConfig(step_size=config.hyper_step_size, jitter=1e-6),
            )
            h_state = hyper_kernel.init(state.theta)
        else:
            raise ValueError(f"unknown stochvol method {config.method!r}")
        h_new, h_info = hyper_kernel.step(k_hyper, h_state)
        theta = h_new.position

        beta, sigma, phi = model.constrain(theta)
        position = jnp.stack([beta, sigma, phi], axis=-1)
        # Sweep-level Info: for a two-block Gibbs
        # sweep every field covers the WHOLE sweep -- accept_prob / accepted
        # are the mean over blocks (accepted in {0, 0.5, 1}), divergent is
        # true if ANY block diverged.  Asserted by
        # tests/test_stochvol.py::test_two_block_info_semantics.
        info = Info(
            accept_prob=0.5 * (lat_prob + h_info.accept_prob),
            accepted=0.5 * (lat_acc.astype(x.dtype)
                            + h_info.accepted.astype(x.dtype)),
            divergent=lat_div | h_info.divergent,
        )
        return StochVolState(position, theta, x), info

    return Kernel(init, step)

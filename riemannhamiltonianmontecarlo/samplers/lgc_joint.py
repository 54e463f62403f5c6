"""Joint (hyperparameter, latent-field) sampler for the log-Gaussian Cox model.

Statistical contract from ``LGC_RMHMC_Paras_LV.m`` (SURVEY.md 2.2 C):
each iteration alternates

1. **hyper block** theta~ = (log sigma^2, log beta) | x: generalized-
   leapfrog RMHMC with L = 1, eps = 0.2, 3 position / 10 momentum
   fixed-point steps (``:41-44``), expected-Fisher + prior metric and
   dense dSigma algebra (see ``models.lgc.LGCJointModel``) -- reusing the
   generic RMHMC kernel with per-block fixed-point counts;
2. **latent block** x | theta: constant-metric leapfrog with
   G = Sigma^{-1} + diag(m exp(mu + diag Sigma)) re-evaluated at the
   *current* hyperparameters, L = 20, eps = 0.1 (``:46-47``).

Every theta move costs dense (n^2, n^2) factorizations (the paper
reports ~90 CPU-hours for the full 6000 x 64 x 64 run).  Batch only a
handful of chains (memory: several (C, D, D)
f32 buffers).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.samplers import rmhmc as rmhmc_mod
from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel, metropolis_accept

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class LGCJointConfig:
    hyper_num_leapfrog: int = 1  # LGC_RMHMC_Paras_LV.m:41
    hyper_step_size: float = 0.2  # :42 (same value as LGC_mMALA_Paras_LV.m:42)
    hyper_num_fixed_point: int = 3  # :43 (position)
    hyper_num_fixed_point_momentum: int = 10  # :44
    latent_num_leapfrog: int = 20  # :46
    latent_step_size: float = 0.1  # :47 (mMALA: 0.07, LGC_mMALA_Paras_LV.m:43)
    randomize_length: bool = True
    random_direction: bool = True
    # "rmhmc" (LGC_RMHMC_Paras_LV.m) or "mmala" (LGC_mMALA_Paras_LV.m):
    # mMALA runs full-curvature manifold MALA on theta~ (:205-294) and
    # metric-preconditioned MALA on the latents with the constant-given-
    # theta metric G = Sigma^{-1} + diag(m exp(mu + diag Sigma)) (:353-375,
    # curvature terms vanish since G is x-independent).
    method: str = "rmhmc"
    # Initial latent field (D,); None = the prior mean mu (the reference
    # init).  NOTE: theta | x is improper at x = mu exactly (the quadratic
    # term vanishes and -1/2 log|Sigma| is unbounded as sigma^2 -> 0), so
    # frozen-latent diagnostics must start from a realistic field.
    latent_init: jax.Array | None = None


class LGCJointState(NamedTuple):
    position: Array  # (C, 2) constrained (sigma^2, beta) -- collected
    theta: Array  # (C, 2) log coords
    x: Array  # (C, D) latent field


def build(model, config: LGCJointConfig = LGCJointConfig()) -> Kernel:
    hyper_cfg = rmhmc_mod.RMHMCConfig(
        step_size=config.hyper_step_size,
        num_leapfrog=config.hyper_num_leapfrog,
        num_fixed_point=config.hyper_num_fixed_point,
        num_fixed_point_momentum=config.hyper_num_fixed_point_momentum,
        randomize_length=config.randomize_length,
        random_direction=config.random_direction,
        jitter=1e-6,
    )

    def init(position: Array) -> LGCJointState:
        """position: (C, 2) constrained initial (sigma^2, beta)."""
        c = position.shape[0]
        theta = jnp.log(position)
        x0 = (jnp.full((model.dim,), model.mu, position.dtype)
              if config.latent_init is None
              else jnp.asarray(config.latent_init, position.dtype))
        x = jnp.broadcast_to(x0, (c, model.dim))
        return LGCJointState(position, theta, x)

    def latent_update(key: Array, x: Array, theta: Array):
        c = x.shape[0]
        k_mom, k_len, k_dir, k_acc = jax.random.split(key, 4)
        sigma_inv, chol_g, g_inv = jax.vmap(model.latent_mass)(theta)

        z = jax.random.normal(k_mom, x.shape, x.dtype)
        p0 = jnp.einsum("...ab,...b->...a", chol_g, z, precision=_PREC)

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

        logp0, grad0 = model.latent_logp_and_grad(x, sigma_inv)

        def body(i, carry):
            xc, pc, gc = carry
            active = (i < n_steps)[:, None]
            p_half = pc + 0.5 * dt * gc
            x_new = xc + dt * jnp.einsum(
                "...ab,...b->...a", g_inv, p_half, precision=_PREC
            )
            _, g_new = model.latent_logp_and_grad(x_new, sigma_inv)
            p_new = p_half + 0.5 * dt * g_new
            xc = jnp.where(active, x_new, xc)
            pc = jnp.where(active, p_new, pc)
            gc = jnp.where(active, g_new, gc)
            return (xc, pc, gc)

        x_prop, p_prop, _ = jax.lax.fori_loop(
            0, config.latent_num_leapfrog, body, (x, p0, grad0)
        )

        def kinetic(p):
            return 0.5 * jnp.einsum(
                "...a,...ab,...b->...", p, g_inv, p, precision=_PREC
            )

        logp_prop, _ = model.latent_logp_and_grad(x_prop, sigma_inv)
        ratio = (logp_prop - kinetic(p_prop)) - (logp0 - kinetic(p0))
        divergent = ~(jnp.isfinite(ratio) & jnp.all(jnp.isfinite(x_prop), axis=-1))
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        return jnp.where(accept[:, None], x_prop, x), accept, accept_prob, divergent

    def latent_mmala_update(key: Array, x: Array, theta: Array):
        """Preconditioned MALA on x | theta (LGC_mMALA_Paras_LV.m:353-375).

        The latent metric is constant in x given theta, so the mMALA
        curvature terms vanish and the log-det parts of both proposal
        densities cancel in the MH ratio.
        """
        k_prop, k_acc = jax.random.split(key)
        sigma_inv, chol_g, g_inv = jax.vmap(model.latent_mass)(theta)
        eps = jnp.asarray(config.latent_step_size, x.dtype)

        def drift(xc):
            logp, grad = model.latent_logp_and_grad(xc, sigma_inv)
            mean = xc + 0.5 * eps * jnp.einsum(
                "...ab,...b->...a", g_inv, grad, precision=_PREC
            )
            return logp, mean

        logp0, mean_fwd = drift(x)
        z = jax.random.normal(k_prop, x.shape, x.dtype)
        # noise ~ N(0, G^{-1}): L^{-T} z with L = chol(G).
        noise = jax.lax.linalg.triangular_solve(
            chol_g, z[..., None], lower=True, transpose_a=True, left_side=True
        )[..., 0]
        x_new = mean_fwd + jnp.sqrt(eps) * noise
        logp_new, mean_rev = drift(x_new)

        def quad(delta):
            t = jnp.einsum("...ij,...i->...j", chol_g, delta, precision=_PREC)
            return jnp.sum(t * t, axis=-1)

        log_q_fwd = -0.5 * quad(x_new - mean_fwd) / eps
        log_q_rev = -0.5 * quad(x - mean_rev) / eps
        ratio = logp_new + log_q_rev - logp0 - log_q_fwd
        divergent = ~(jnp.isfinite(ratio) & jnp.all(jnp.isfinite(x_new), axis=-1))
        accept, accept_prob = metropolis_accept(k_acc, ratio, divergent)
        return jnp.where(accept[:, None], x_new, x), accept, accept_prob, divergent

    if config.method == "mmala":
        from riemannhamiltonianmontecarlo.samplers import mmala as mmala_mod

        hyper_mmala_cfg = mmala_mod.MMALAConfig(
            step_size=config.hyper_step_size, jitter=1e-6
        )

    def step(key: Array, state: LGCJointState) -> tuple[LGCJointState, Info]:
        k_hyper, k_latent = jax.random.split(key)

        # Block 1: hyperparameters (reference order: theta first, :168).
        hyper_model = model.hyper_manifold(state.x)
        if config.method == "mmala":
            hyper_kernel = mmala_mod.build(hyper_model, hyper_mmala_cfg)
            h_state = hyper_kernel.init(state.theta)
            h_new, h_info = hyper_kernel.step(k_hyper, h_state)
        else:
            hyper_kernel = rmhmc_mod.build(hyper_model, hyper_cfg)
            # init() computes the full fused geometry once; step() reuses it
            # via the state's geo cache (one O(D^3) pass saved per joint
            # step vs seeding the state with a bare logp call).
            h_state = hyper_kernel.init(state.theta)
            h_new, h_info = hyper_kernel.step(k_hyper, h_state)
        theta = h_new.position

        # Block 2: latents at the current hyperparameters.
        if config.method == "mmala":
            x, lat_acc, lat_prob, lat_div = latent_mmala_update(k_latent, state.x, theta)
        else:
            x, lat_acc, lat_prob, lat_div = latent_update(k_latent, state.x, theta)

        position = jnp.exp(theta)
        # Sweep-level Info: every field covers the
        # whole two-block sweep -- accept_prob / accepted are the mean over
        # blocks, divergent is true if ANY block diverged.
        info = Info(
            accept_prob=0.5 * (lat_prob + h_info.accept_prob),
            accepted=0.5 * (lat_acc.astype(x.dtype)
                            + h_info.accepted.astype(x.dtype)),
            divergent=lat_div | h_info.divergent,
        )
        return LGCJointState(position, theta, x), info

    return Kernel(init, step)

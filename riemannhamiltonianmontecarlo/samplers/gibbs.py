"""Holmes-Held auxiliary-variable Gibbs sampler for logistic regression.

Statistical contract from the reference (``code/gibbs_sampler.py:73-139`` /
MATLAB ``BLR_holmes_joint_update.m:183-220``):

* latent z_j one-sided truncated normals with sign given by the label
  (``gibbs_sampler.py:86-93,117-125``);
* per-iteration: V = (X^T Lambda^{-1} X + I/v)^{-1}, L = chol(V),
  S = V X^T, B = S Lambda^{-1} z (``gibbs_sampler.py:102-105``);
* a *sequential* sweep over the N data points updating z_j from its full
  conditional and B by a rank-one correction (``gibbs_sampler.py:109-126``)
  -- a true serial dependency, mapped to a per-chain ``lax.scan`` over j
  with all chains advancing in lockstep (SURVEY.md hard part (f):
  throughput comes from the chain axis, not the data axis);
* beta = B + L T, T ~ N(0, I) (``gibbs_sampler.py:128-129``);
* mixing weights lambda_j ~ GIG(1/2, 1, r_j^2) by batched rejection
  sampling with the Kolmogorov-Smirnov squeeze series (``ops/gig.py``).

Initialization: the reference draws initial z from the truncated normal
(``gibbs_sampler.py:86-93``); ``init`` here sets z to the truncated
normal's mean (+-sqrt(2/pi)) since ``Kernel.init`` is deterministic --
irrelevant after burn-in.

The 690 truncated-normal draws of the sweep form a true dependency chain
(z_j's mean depends on B, updated by every previous j), so throughput
comes from the chain axis -- the design SURVEY.md section 7 hard part (f)
prescribes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo import ops
from riemannhamiltonianmontecarlo.ops.gig import sample_gig_half
from riemannhamiltonianmontecarlo.ops.truncnorm import truncated_normal_onesided
from riemannhamiltonianmontecarlo.samplers.base import Info, Kernel

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST
# Unroll factor of the sequential z/B sweep, whose per-datapoint loop body
# is a handful of small (C,)-sized ops.  Not yet tuned on the GPU.
_UNROLL = 8


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    prior_variance: float = 100.0  # v, code/gibbs_sampler.py:73
    max_rejection_rounds: int = 64


class GibbsState(NamedTuple):
    position: Array  # (C, D) current beta draw
    z: Array  # (C, N) latent utilities
    lam: Array  # (C, N) logistic mixing weights


def build(model, config: GibbsConfig = GibbsConfig()) -> Kernel:
    x = model.X  # (N, D)
    t = model.t  # (N,)
    n, d = x.shape
    positive = t == 1.0
    v_prior = config.prior_variance

    def init(position: Array) -> GibbsState:
        c = position.shape[0]
        half_mean = jnp.sqrt(2.0 / jnp.pi).astype(position.dtype)
        z0 = jnp.where(positive, half_mean, -half_mean)
        z = jnp.broadcast_to(z0, (c, n)).astype(position.dtype)
        lam = jnp.ones((c, n), position.dtype)
        return GibbsState(position, z, lam)

    def step(key: Array, state: GibbsState) -> tuple[GibbsState, Info]:
        c = state.position.shape[0]
        k_sweep, k_beta, k_lam = jax.random.split(key, 3)

        inv_lam = 1.0 / state.lam  # (C, N)
        v = jnp.einsum("cn,na,nb->cab", inv_lam, x, x, precision=_PREC)
        v = v + jnp.eye(d, dtype=v.dtype) / v_prior
        v = ops.inv_psd(v)  # posterior covariance given lambda
        chol_v = ops.cholesky(v)
        s = jnp.einsum("cde,ne->cdn", v, x, precision=_PREC)  # (C, D, N)
        b = jnp.einsum("cdn,cn->cd", s, inv_lam * state.z, precision=_PREC)
        h = jnp.einsum("nd,cdn->cn", x, s, precision=_PREC)  # h_j = x_j^T V x_j

        # Sequential z / B sweep (code/gibbs_sampler.py:109-126).  Each j is
        # visited exactly once per iteration, so z_old_j is always the
        # *previous* iteration's value: stream it in as a scan input and
        # collect z_new as the stacked scan output -- the carry holds only
        # the (C, D) running B, so the loop body is a few (C,)-sized ops
        # with no (C, N)-buffer copies.
        xs = (
            x,  # (N, D) rows
            h.T,  # (N, C)
            state.lam.T,  # (N, C)
            positive,
            jnp.moveaxis(s, 2, 0),  # (N, C, D)
            jax.random.split(k_sweep, n),
            state.z.T,  # (N, C) previous-iteration latents
        )

        def sweep(b_cur, inp):
            x_j, h_j, lam_j, pos_j, s_j, k_j, z_old = inp
            # lambda_j > h_j holds exactly (V^{-1} >= x_j x_j^T / lambda_j);
            # clamp the gap against f32 rounding.
            w_j = h_j / jnp.maximum(lam_j - h_j, 1e-12)
            m = jnp.einsum("cd,d->c", b_cur, x_j, precision=_PREC)
            m = m - w_j * (z_old - m)
            q = lam_j * (w_j + 1.0)
            z_new = truncated_normal_onesided(k_j, m, jnp.sqrt(q), pos_j)
            b_cur = b_cur + ((z_new - z_old) / lam_j)[:, None] * s_j
            return b_cur, z_new

        b, z_t = jax.lax.scan(sweep, b, xs, unroll=_UNROLL)
        z = z_t.T  # (C, N)

        # beta = B + L T (code/gibbs_sampler.py:128-129).
        beta = b + ops.mvn_sample(k_beta, chol_v)

        # lambda_j ~ GIG(1/2, 1, (z_j - x_j beta)^2) (code/gibbs_sampler.py:133-135).
        resid = z - jnp.einsum("cd,nd->cn", beta, x, precision=_PREC)
        lam = sample_gig_half(
            k_lam, resid**2, max_rejection_rounds=config.max_rejection_rounds
        )

        bad = ~(
            jnp.all(jnp.isfinite(beta), axis=-1)
            & jnp.all(jnp.isfinite(z), axis=-1)
            & jnp.all(jnp.isfinite(lam), axis=-1)
        )
        ones = jnp.ones((c,), beta.dtype)
        return GibbsState(beta, z, lam), Info(ones, ones > 0, bad)

    return Kernel(init, step)

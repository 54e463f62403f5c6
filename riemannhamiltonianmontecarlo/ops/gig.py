"""Batched GIG(1/2, 1, r^2) sampling for Holmes-Held logistic mixing weights.

Statistical contract from the reference (``code/gibbs_sampler.py:14-70`` /
MATLAB ``BLR_holmes_joint_update.m:250-337`` "Sample_Lambda"): draw a
candidate lambda from the inverse-Gaussian-based proposal, then
accept/reject by squeezing the alternating Kolmogorov-Smirnov series --
the "rightmost interval" series for lambda > 4/3 and the "leftmost"
series otherwise.  (The MATLAB branches on ``U > 4/3`` which never fires;
the Python port and the Holmes & Held (2006) appendix branch on
``Lambda > 4/3``, which is the contract used here.)

Redesign: the reference loops scalar-at-a-time with unbounded
``while``; here the full (chains x data) batch runs lockstep
``lax.while_loop``s with per-element decided/accepted masks -- elements
that finish early simply stop contributing to the loop condition
(SURVEY.md hard part (c)).  Series terms are evaluated in log space.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

_TWO_STEPS_PER_BODY = 2  # each body consumes one subtract + one add term


class _SqueezeCarry(NamedTuple):
    z: Array
    j: Array  # odd step index (1, 3, 5, ...)
    decided: Array
    accept: Array


def _pow(x_log: Array, exponent: Array) -> Array:
    return jnp.exp(x_log * exponent)


def _rightmost_accept(u: Array, lam: Array, max_bodies: int) -> tuple[Array, Array]:
    """Squeeze test for lambda > 4/3.  Returns (decided, accept)."""
    x_log = -0.5 * lam  # log X, X = exp(-lambda/2)

    def body(c: _SqueezeCarry) -> _SqueezeCarry:
        n1 = c.j + 1.0  # subtract term index (2, 4, ...)
        z_sub = c.z - n1**2 * _pow(x_log, n1**2 - 1.0)
        acc_now = z_sub > u
        n2 = c.j + 2.0  # add term index (3, 5, ...)
        z_add = z_sub + n2**2 * _pow(x_log, n2**2 - 1.0)
        rej_now = z_add < u
        newly = ~c.decided
        accept = jnp.where(newly & acc_now, True, c.accept)
        decided = c.decided | acc_now | rej_now
        return _SqueezeCarry(z_add, c.j + _TWO_STEPS_PER_BODY, decided, accept)

    return _run_squeeze(body, u, max_bodies)


def _leftmost_accept(u: Array, lam: Array, max_bodies: int) -> tuple[Array, Array]:
    """Squeeze test for lambda <= 4/3 (series in the transformed domain)."""
    pi2 = jnp.pi**2
    lam_safe = jnp.maximum(lam, 1e-20)
    h = (
        0.5 * jnp.log(2.0)
        + 2.5 * jnp.log(jnp.pi)
        - 2.5 * jnp.log(lam_safe)
        - pi2 / (2.0 * lam_safe)
        + 0.5 * lam_safe
    )
    log_u = jnp.log(u)
    x_log = -pi2 / (2.0 * lam_safe)  # log X
    k = lam_safe / pi2

    def safe_log(z):
        return jnp.where(z > 0.0, jnp.log(jnp.maximum(z, 1e-300)), -jnp.inf)

    def body(c: _SqueezeCarry) -> _SqueezeCarry:
        z_sub = c.z - k * _pow(x_log, c.j**2 - 1.0)
        acc_now = h + safe_log(z_sub) > log_u
        n2 = c.j + 2.0
        z_add = z_sub + n2**2 * _pow(x_log, n2**2 - 1.0)
        rej_now = h + safe_log(z_add) < log_u
        newly = ~c.decided
        accept = jnp.where(newly & acc_now, True, c.accept)
        decided = c.decided | acc_now | rej_now
        return _SqueezeCarry(z_add, c.j + _TWO_STEPS_PER_BODY, decided, accept)

    return _run_squeeze(body, u, max_bodies)


def _run_squeeze(body, u: Array, max_bodies: int) -> tuple[Array, Array]:
    init = _SqueezeCarry(
        z=jnp.ones_like(u),
        j=jnp.ones_like(u),
        decided=jnp.zeros(u.shape, bool),
        accept=jnp.zeros(u.shape, bool),
    )

    def cond(c: _SqueezeCarry):
        return (~jnp.all(c.decided)) & (c.j[(0,) * c.j.ndim] < 1 + _TWO_STEPS_PER_BODY * max_bodies)

    def guarded_body(c: _SqueezeCarry):
        new = body(c)
        # Frozen once decided.
        return _SqueezeCarry(
            jnp.where(c.decided, c.z, new.z),
            new.j,
            new.decided,
            jnp.where(c.decided, c.accept, new.accept),
        )

    out = jax.lax.while_loop(cond, guarded_body, init)
    return out.decided, out.accept


class _GigCarry(NamedTuple):
    key: Array
    lam: Array
    ok: Array
    tries: Array


def sample_gig_half(
    key: Array,
    r2: Array,
    *,
    max_rejection_rounds: int = 64,
    max_series_bodies: int = 32,
) -> Array:
    """lambda ~ GIG(1/2, 1, r^2), elementwise over ``r2``.

    One lockstep rejection round draws proposals for every element; the
    squeeze series decides accept/reject; undecided-after-cap counts as
    reject (resample), preserving correctness.
    """
    r = jnp.sqrt(jnp.maximum(r2, 1e-16))

    def cond(c: _GigCarry):
        return (~jnp.all(c.ok)) & (c.tries < max_rejection_rounds)

    def body(c: _GigCarry):
        key, k_y, k_side, k_u = jax.random.split(c.key, 4)
        y0 = jax.random.normal(k_y, r.shape, r.dtype) ** 2
        # Reference form: y = 1 + (y0 - sqrt(y0 (4r + y0))) / (2r)
        # (``code/gibbs_sampler.py:59``) suffers catastrophic cancellation
        # for small r in f32 (y rounds to 0 -> lambda = r/0 = inf).
        # Rationalized, subtraction-free equivalent:
        #   y = 4 r y0 / (y0 + sqrt(y0 (y0 + 4r)))^2.
        root = y0 + jnp.sqrt(y0 * (y0 + 4.0 * r))
        y = 4.0 * r * y0 / jnp.maximum(root * root, 1e-30)
        u_side = jax.random.uniform(k_side, r.shape, r.dtype)
        lam_cand = jnp.where(u_side <= 1.0 / (1.0 + y), r / y, r * y)
        lam_cand = jnp.maximum(lam_cand, 1e-12)  # guard: y -> 0 numerically
        u = jax.random.uniform(k_u, r.shape, r.dtype)
        dec_r, acc_r = _rightmost_accept(u, lam_cand, max_series_bodies)
        dec_l, acc_l = _leftmost_accept(u, lam_cand, max_series_bodies)
        right = lam_cand > 4.0 / 3.0
        decided = jnp.where(right, dec_r, dec_l)
        accept = decided & jnp.where(right, acc_r, acc_l)
        take = (~c.ok) & accept
        return _GigCarry(
            key,
            jnp.where(take, lam_cand, c.lam),
            c.ok | accept,
            c.tries + 1,
        )

    init = _GigCarry(
        key=key,
        lam=jnp.ones_like(r),
        ok=jnp.zeros(r.shape, bool),
        tries=jnp.zeros((), jnp.int32),
    )
    out = jax.lax.while_loop(cond, body, init)
    return out.lam

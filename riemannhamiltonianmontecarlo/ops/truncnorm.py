"""Batched one-sided truncated-normal sampling, f32-tail-safe.

The reference draws latent-variable truncated normals one scalar at a
time with ``scipy.stats.truncnorm.rvs`` (``code/gibbs_sampler.py:86-93,
117-125``) in float64, which uses dedicated tail algorithms.  A naive
inverse-CDF port breaks in float32: for a strongly violated constraint
(lower bound a >~ 5 standard deviations) ``ndtr(a)`` saturates/underflows
and the draw degenerates -- on the australian data (logits up to ~30)
this silently inflates the latent z's until chains blow up.

Vectorized scheme, no unbounded loops:

* |bound| <= 3: plain inverse CDF (f32-accurate there);
* bound > 3 (sampling the far tail): Rayleigh-tail inversion
  ``z = sqrt(a^2 - 2 log(1-u))`` -- an exact sampler for the density
  proportional to z exp(-z^2/2) on (a, inf) -- corrected to the true
  normal tail by accept probability ``a/z`` (Robert 1995), with a fixed
  number of lockstep retry rounds (acceptance >= 0.9 for a > 3, so
  3 rounds leave < 0.1% of lanes on the final candidate).

Only the standard one-sided-above sampler is needed; the below-side
follows by symmetry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

_TAIL_SPLIT = 3.0
_RETRY_ROUNDS = 3


def _std_truncnorm_above(key: Array, a: Array) -> Array:
    """z ~ N(0,1) conditioned on z > a, elementwise (any real a)."""
    k_small, k_tail = jax.random.split(key)

    # Central path: inverse CDF on [ndtr(a), 1).  Clip a so ndtr stays in
    # f32-resolvable range; lanes with a > split use the tail path anyway.
    a_c = jnp.clip(a, -12.0, _TAIL_SPLIT)
    lo = jax.scipy.special.ndtr(a_c)
    u = jax.random.uniform(k_small, a.shape, a.dtype, minval=lo, maxval=1.0)
    z_small = jax.scipy.special.ndtri(jnp.clip(u, 1e-30, 1.0 - 1e-7))
    z_small = jnp.maximum(z_small, a_c)  # guard fp round-off at the bound

    # Tail path: Rayleigh inversion + a/z thinning, fixed masked rounds.
    a_t = jnp.maximum(a, _TAIL_SPLIT)
    z_tail = a_t
    accepted = jnp.zeros(a.shape, bool)
    keys = jax.random.split(k_tail, _RETRY_ROUNDS)
    for r in range(_RETRY_ROUNDS):
        u1, u2 = jax.random.split(keys[r])
        e = jax.random.uniform(u1, a.shape, a.dtype, minval=1e-7, maxval=1.0)
        cand = jnp.sqrt(a_t * a_t - 2.0 * jnp.log(e))
        acc = jax.random.uniform(u2, a.shape, a.dtype) <= a_t / cand
        take = ~accepted  # first accepted wins; else keep refreshing
        z_tail = jnp.where(take, cand, z_tail)
        accepted = accepted | acc
    return jnp.where(a > _TAIL_SPLIT, z_tail, z_small)


def truncated_normal_onesided(
    key: Array,
    mean: Array,
    std: Array,
    positive: Array,
) -> Array:
    """Sample z ~ N(mean, std^2) truncated to z > 0 (positive) or z < 0.

    ``positive`` is a boolean array broadcastable against ``mean``;
    labels t = 1 truncate to the positive half-line, t = 0 to the
    negative (``code/gibbs_sampler.py:116-125``).
    """
    mean, std = jnp.broadcast_arrays(mean, std)
    positive = jnp.broadcast_to(positive, mean.shape)
    # Positive side: z = m + s * TN_above((0 - m)/s).
    # Negative side by symmetry: z = -( (-m) + s * TN_above(m/s) ).
    a = jnp.where(positive, -mean / std, mean / std)
    z_std = _std_truncnorm_above(key, a)
    z = jnp.where(positive, mean + std * z_std, -(-mean + std * z_std))
    return z

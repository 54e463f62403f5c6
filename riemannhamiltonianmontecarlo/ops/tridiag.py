"""Batched symmetric-tridiagonal linear algebra for chain-structured models.

The stochastic-volatility latent block has a *constant* tridiagonal
metric G = AR(1)-precision + I/2 (``StochVol_RMHMC.m:132-141``), so its
leapfrog needs, per MCMC step: one factorization (momentum sampling +
log-det) and ~L tridiagonal solves ``G \\ p`` (``StochVol_RMHMC.m:166``).
MATLAB uses sparse LU on one chain; here everything is batched over the
chain axis (..., T):

* ``cholesky``: the bidiagonal factor via a length-T ``lax.scan`` --
  inherently sequential but needed only once per MCMC step, vectorized
  across all chains;
* ``matvec_chol``: L z (bidiagonal) -- one shifted multiply-add;
* ``solve``: parallel cyclic reduction (PCR), O(log T) lockstep rounds of
  elementwise work -- the parallel replacement for the sequential
  Thomas algorithm in the hot leapfrog loop (SURVEY.md section 5,
  long-context analog).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class TridiagChol(NamedTuple):
    """G = L L^T with L lower bidiagonal: diag ``ld``, subdiag ``e``."""

    ld: Array  # (..., T)
    e: Array  # (..., T-1)


def cholesky(diag: Array, off: Array) -> TridiagChol:
    """Bidiagonal Cholesky of symmetric tridiagonal (diag, off).

    diag: (..., T), off: (..., T-1).  Scan over T, batched elsewhere.
    """
    t = diag.shape[-1]
    # Move time to the leading axis for scan.
    d_t = jnp.moveaxis(diag, -1, 0)
    o_t = jnp.moveaxis(off, -1, 0)

    def body(carry, inp):
        prev_ld = carry
        d_i, o_prev = inp
        # o_prev is off[i-1] (zero for i = 0 handled by padding below)
        e_i = o_prev / prev_ld
        ld_i = jnp.sqrt(d_i - e_i * e_i)
        return ld_i, (ld_i, e_i)

    o_padded = jnp.concatenate([jnp.zeros_like(o_t[:1]), o_t], axis=0)
    init = jnp.ones_like(d_t[0])  # e_0 = 0/1 = 0
    _, (ld, e) = jax.lax.scan(body, init, (d_t, o_padded))
    return TridiagChol(jnp.moveaxis(ld, 0, -1), jnp.moveaxis(e[1:], 0, -1))


def logdet_from_chol(chol: TridiagChol) -> Array:
    return 2.0 * jnp.sum(jnp.log(chol.ld), axis=-1)


def matvec_chol(chol: TridiagChol, z: Array) -> Array:
    """(L z)_t = ld_t z_t + e_{t-1} z_{t-1}  -- samples N(0, G) from iid z."""
    shifted = jnp.pad(chol.e * z[..., :-1], [(0, 0)] * (z.ndim - 1) + [(1, 0)])
    return chol.ld * z + shifted


def matvec(diag: Array, off: Array, x: Array) -> Array:
    """Symmetric tridiagonal matvec (G x)."""
    pad = [(0, 0)] * (x.ndim - 1)
    lower = jnp.pad(off * x[..., :-1], pad + [(1, 0)])
    upper = jnp.pad(off * x[..., 1:], pad + [(0, 1)])
    return diag * x + lower + upper


def solve(diag: Array, off: Array, b: Array) -> Array:
    """Solve G x = b for symmetric tridiagonal G by parallel cyclic reduction.

    diag: (..., T), off: (..., T-1), b: (..., T).  ceil(log2 T) lockstep
    rounds; out-of-range neighbors are treated as identity rows.
    """
    t = diag.shape[-1]
    a = jnp.pad(off, [(0, 0)] * (off.ndim - 1) + [(1, 0)])  # a_i = G[i, i-1]
    c = jnp.pad(off, [(0, 0)] * (off.ndim - 1) + [(0, 1)])  # c_i = G[i, i+1]
    bb = diag
    d = b

    def shift_up(x, s):  # x_{i-s}, zero-fill
        return jnp.roll(x, s, axis=-1).at[..., :s].set(0.0)

    def shift_down(x, s):  # x_{i+s}, zero-fill
        return jnp.roll(x, -s, axis=-1).at[..., -s:].set(0.0)

    def shift_up_b(x, s):  # b_{i-s} with identity fill (1.0)
        return jnp.roll(x, s, axis=-1).at[..., :s].set(1.0)

    def shift_down_b(x, s):
        return jnp.roll(x, -s, axis=-1).at[..., -s:].set(1.0)

    s = 1
    while s < t:
        alpha = -a / shift_up_b(bb, s)
        gamma = -c / shift_down_b(bb, s)
        bb = bb + alpha * shift_up(c, s) + gamma * shift_down(a, s)
        d = d + alpha * shift_up(d, s) + gamma * shift_down(d, s)
        a = alpha * shift_up(a, s)
        c = gamma * shift_down(c, s)
        s *= 2
    return d / bb

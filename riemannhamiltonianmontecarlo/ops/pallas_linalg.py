"""Pallas (Triton) kernels: chain-batched small-matrix Cholesky and solve.

One GPU thread owns one chain.  The batch is laid out chains-last, as
(D*D, C) for the matrices and (D, C) for the right-hand sides, so entry
(i, j) of ``BLOCK_C`` consecutive chains is one coalesced (BLOCK_C,)
vector load.  The D loop is unrolled at trace time (D is static) and the
lower triangle stays in registers: D(D+1)/2 floats per thread, which fits
the 255-register budget up to ``MAX_DIM``.  One program factors
``BLOCK_C`` matrices and runs both triangular solves and the log-det
without writing the factor back to device memory.

Under a chain-sharded mesh each device runs the kernel on its own chains
(``custom_partitioning`` over the leading axis); the D axes are never
sharded.

Exposed ops:

* ``cholesky(g)``: lower factor, (C, D, D) -> (C, D, D);
* ``chol_solve_logdet(g, b)``: fused factor + solve(G, b) + log|G| for a
  (C, D, D), (C, D) batch -- what each RMHMC fixed-point step needs.

``interpret=True`` runs the same kernels on the CPU for tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as plgpu
from jax.sharding import NamedSharding, PartitionSpec

Array = jax.Array

BLOCK_C = 128  # chains per program: four warps, one chain per thread
NUM_WARPS = 4
# Largest D whose lower triangle (D(D+1)/2 floats) stays in registers.
MAX_DIM = 16


def _load_lower(g_ref, d: int):
    """Lower triangle of the (D*D, BLOCK_C) block as nested lists of vectors."""
    return [[g_ref[i * d + j, :] for j in range(i + 1)] for i in range(d)]


def _chol(a, d: int):
    """Left-looking Cholesky on lists of (BLOCK_C,) vectors."""
    l = [[None] * (i + 1) for i in range(d)]
    for j in range(d):
        s = a[j][j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        ljj = jnp.sqrt(s)
        l[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, d):
            s = a[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    return l


def _cho_solve(l, b, d: int):
    """L L^T x = b, forward then back substitution."""
    y = []
    for i in range(d):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y.append(s / l[i][i])
    x = [None] * d
    for i in reversed(range(d)):
        s = y[i]
        for k in range(i + 1, d):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return x


def _chol_kernel(g_ref, l_ref, *, d: int):
    l = _chol(_load_lower(g_ref, d), d)
    zero = jnp.zeros_like(l[0][0])
    for i in range(d):
        for j in range(d):
            l_ref[i * d + j, :] = l[i][j] if j <= i else zero


def _fused_kernel(g_ref, b_ref, x_ref, logdet_ref, *, d: int):
    l = _chol(_load_lower(g_ref, d), d)
    x = _cho_solve(l, [b_ref[i, :] for i in range(d)], d)
    for i in range(d):
        x_ref[i, :] = x[i]
    logdet = jnp.log(l[0][0])
    for j in range(1, d):
        logdet = logdet + jnp.log(l[j][j])
    logdet_ref[0, :] = 2.0 * logdet


def _chains_last(g: Array) -> tuple[Array, int]:
    """(C, D, D) -> (D*D, Cp), chains padded to a BLOCK_C multiple with
    identity matrices so sqrt/division stay finite on the pad lanes."""
    c, d, _ = g.shape
    pad = (-c) % BLOCK_C
    if pad:
        eye = jnp.broadcast_to(jnp.eye(d, dtype=g.dtype), (pad, d, d))
        g = jnp.concatenate([g, eye], axis=0)
    return g.reshape(c + pad, d * d).T, c + pad


def _call(kernel, d: int, cp: int, in_specs, out_specs, out_shape, interpret: bool):
    return pl.pallas_call(
        functools.partial(kernel, d=d),
        out_shape=out_shape,
        grid=(cp // BLOCK_C,),
        in_specs=in_specs,
        out_specs=out_specs,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )


def _cholesky(g: Array, interpret: bool) -> Array:
    c, d, _ = g.shape
    gt, cp = _chains_last(g)
    mat = pl.BlockSpec((d * d, BLOCK_C), lambda i: (0, i))
    out = _call(
        _chol_kernel, d, cp, [mat], mat,
        jax.ShapeDtypeStruct((d * d, cp), g.dtype), interpret,
    )(gt)
    return out[:, :c].T.reshape(c, d, d)


def _chol_solve_logdet(g: Array, b: Array, interpret: bool) -> tuple[Array, Array]:
    c, d, _ = g.shape
    gt, cp = _chains_last(g)
    bt = jnp.pad(b, ((0, cp - c), (0, 0))).T  # (D, Cp)
    mat = pl.BlockSpec((d * d, BLOCK_C), lambda i: (0, i))
    vec = pl.BlockSpec((d, BLOCK_C), lambda i: (0, i))
    row = pl.BlockSpec((1, BLOCK_C), lambda i: (0, i))
    x, logdet = _call(
        _fused_kernel, d, cp, [mat, vec], (vec, row),
        (jax.ShapeDtypeStruct((d, cp), g.dtype), jax.ShapeDtypeStruct((1, cp), g.dtype)),
        interpret,
    )(gt, bt)
    return x[:, :c].T, logdet[0, :c]


def _chains_only(mesh, arg_shapes, tree):
    """Shard every leaf of ``tree`` like the first argument's chain axis."""
    spec = arg_shapes[0].sharding.spec
    chain = spec[0] if len(spec) else None
    return jax.tree.map(
        lambda x: NamedSharding(mesh, PartitionSpec(chain, *([None] * (len(x.shape) - 1)))),
        tree,
    )


def _over_chains(fn, rule: str):
    """``fn`` partitioned along the leading (chain) axis only."""
    wrapped = custom_partitioning(fn)

    def partition(mesh, arg_shapes, result_shape):
        return (mesh, fn, _chains_only(mesh, arg_shapes, result_shape),
                _chains_only(mesh, arg_shapes, arg_shapes))

    def infer(mesh, arg_shapes, result_shape):
        return _chains_only(mesh, arg_shapes, result_shape)

    wrapped.def_partition(partition=partition, infer_sharding_from_operands=infer,
                          sharding_rule=rule, need_replication_factors=("i", "j"))
    return wrapped


def _bind(fn, interpret: bool):
    return lambda *args: fn(*args, interpret)


_CHOLESKY = {flag: _over_chains(_bind(_cholesky, flag), "c i j -> c i j")
             for flag in (False, True)}
_CHOL_SOLVE_LOGDET = {flag: _over_chains(_bind(_chol_solve_logdet, flag), "c i j, c i -> c i, c")
                      for flag in (False, True)}


@functools.partial(jax.jit, static_argnames=("interpret",))
def cholesky(g: Array, *, interpret: bool = False) -> Array:
    """Lower Cholesky factor of a (C, D, D) PD batch."""
    return _CHOLESKY[interpret](g)


@functools.partial(jax.jit, static_argnames=("interpret",))
def chol_solve_logdet(g: Array, b: Array, *, interpret: bool = False) -> tuple[Array, Array]:
    """Fused Cholesky + solve(G, b) + log|G| for a (C, D, D), (C, D) batch."""
    return _CHOL_SOLVE_LOGDET[interpret](g, b)

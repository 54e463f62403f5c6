"""Chain-batched small-matrix linear algebra.

RMHMC / mMALA / IWLS on the reference workloads need Cholesky
factorizations, triangular solves, PD inverses and log-determinants of
*tiny* (D = 7..25) matrices, but batched over thousands of chains
(reference does one D x D LAPACK call per step, ``code/rmhmc.py:58-60``).

Per-matrix LAPACK-style kernels waste the hardware at these sizes, so the
chain axis stays vectorized and the factorization is *unrolled* over the
static dimension D: each of the D outer-product elimination steps is an
elementwise op over the whole (chains, D, D) batch with no dynamic
control flow.  On a GPU, a (C, D, D) batch with D <= ``pallas_linalg.
MAX_DIM`` instead goes to the Pallas (Triton) kernel, which does the
factor (and the fused solve and log-det) in one launch per call.

``method="xla"`` uses the built-in batched primitives
(``jnp.linalg.cholesky`` / ``jax.lax.linalg.triangular_solve``), which
is also the automatic choice above ``UNROLL_MAX_DIM`` (LGC's 4096-dim
covariance factorization uses those directly).

All functions accept arbitrary leading batch axes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo.ops import pallas_linalg

Array = jax.Array

# Full f32 multiply precision: these factors feed MH log-density ratios.
PRECISION = jax.lax.Precision.HIGHEST

# Above this dimension the unrolled elimination emits too many HLO ops and
# the blocked XLA primitives take over.
UNROLL_MAX_DIM = 48


def uses_kernel(d: int) -> bool:
    """Whether a (C, D, D) batch goes to the Pallas kernel on a GPU."""
    return d <= pallas_linalg.MAX_DIM


def _dispatch(kernel, plain, method: str | None, a: Array, *args):
    """``kernel`` for 3-D batches on a GPU (always for method="pallas"),
    ``plain`` otherwise; the platform is the one the call is compiled for."""
    if a.ndim == 3 and method == "pallas":
        return kernel(a, *args)
    if a.ndim == 3 and method is None and uses_kernel(a.shape[-1]):
        return jax.lax.platform_dependent(a, *args, cuda=kernel, default=plain)
    return plain(a, *args)


def _use_unrolled(d: int, method: str | None) -> bool:
    if method == "unrolled":
        return True
    if method == "xla":
        return False
    return d <= UNROLL_MAX_DIM


def cholesky(a: Array, *, method: str | None = None) -> Array:
    """Lower Cholesky factor of PD matrices.  (..., D, D) -> (..., D, D).

    method: None (auto), "unrolled", "xla", or "pallas" (the chains-last
    Triton kernel, GPU only, 3-D (C, D, D) batch -- ops/pallas_linalg.py).
    """
    return _dispatch(pallas_linalg.cholesky,
                     functools.partial(_cholesky_plain, method=method), method, a)


def _cholesky_plain(a: Array, *, method: str | None) -> Array:
    d = a.shape[-1]
    if not _use_unrolled(d, method):
        return jnp.linalg.cholesky(a)
    idx = jnp.arange(d)
    rem = a
    cols = []
    for j in range(d):
        diag = jnp.sqrt(rem[..., j, j])
        col = rem[..., :, j] / diag[..., None]
        col = jnp.where(idx >= j, col, jnp.zeros_like(col))
        cols.append(col)
        rem = rem - col[..., :, None] * col[..., None, :]
    return jnp.stack(cols, axis=-1)


def solve_lower_triangular(l: Array, b: Array, *, method: str | None = None) -> Array:
    """Solve L y = b with L lower triangular.  b: (..., D) or (..., D, K)."""
    d = l.shape[-1]
    vector = b.ndim == l.ndim - 1
    if vector:
        b = b[..., None]
    if not _use_unrolled(d, method):
        y = jax.lax.linalg.triangular_solve(l, b, left_side=True, lower=True)
    else:
        rows = []
        for i in range(d):
            s = b[..., i, :]
            for k in range(i):
                s = s - l[..., i, k, None] * rows[k]
            rows.append(s / l[..., i, i, None])
        y = jnp.stack(rows, axis=-2)
    return y[..., 0] if vector else y


def solve_upper_from_lower(l: Array, b: Array, *, method: str | None = None) -> Array:
    """Solve L^T y = b (back substitution on the transpose of lower L)."""
    d = l.shape[-1]
    vector = b.ndim == l.ndim - 1
    if vector:
        b = b[..., None]
    if not _use_unrolled(d, method):
        y = jax.lax.linalg.triangular_solve(
            l, b, left_side=True, lower=True, transpose_a=True
        )
    else:
        rows: list = [None] * d
        for i in reversed(range(d)):
            s = b[..., i, :]
            for k in range(i + 1, d):
                s = s - l[..., k, i, None] * rows[k]
            rows[i] = s / l[..., i, i, None]
        y = jnp.stack(rows, axis=-2)
    return y[..., 0] if vector else y


def cho_solve(l: Array, b: Array, *, method: str | None = None) -> Array:
    """Solve A x = b given the lower Cholesky factor L of A."""
    return solve_upper_from_lower(l, solve_lower_triangular(l, b, method=method), method=method)


def solve_psd(a: Array, b: Array, *, method: str | None = None) -> Array:
    """Solve A x = b for symmetric PD A via Cholesky."""
    def plain(a, b):
        return cho_solve(_cholesky_plain(a, method=method), b, method=method)

    if b.ndim != a.ndim - 1:  # matrix right-hand side
        return plain(a, b)
    return _dispatch(lambda a, b: pallas_linalg.chol_solve_logdet(a, b)[0], plain, method, a, b)


def inv_psd(a: Array, *, method: str | None = None) -> Array:
    """Inverse of symmetric PD matrices via Cholesky."""
    l = cholesky(a, method=method)
    return inv_psd_from_chol(l, method=method)


def inv_psd_from_chol(l: Array, *, method: str | None = None) -> Array:
    """A^{-1} = L^{-T} L^{-1} from the lower Cholesky factor."""
    d = l.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=l.dtype), l.shape)
    linv = solve_lower_triangular(l, eye, method=method)
    return jnp.matmul(jnp.swapaxes(linv, -1, -2), linv, precision=PRECISION)


def logdet_from_chol(l: Array) -> Array:
    """log|A| = 2 sum log diag L.  (..., D, D) -> (...,)."""
    diag = jnp.diagonal(l, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def mvn_sample(key: Array, chol_l: Array, shape: tuple[int, ...] = ()) -> Array:
    """Sample z ~ N(0, L L^T) as L @ eps.

    NOTE the reference Python draws ``randn(1,D) @ np.linalg.cholesky(G)``
    (``code/rmhmc.py:80``) whose covariance is L^T L != G -- a port bug;
    the MATLAB oracle uses upper-triangular ``chol`` so its draw *is*
    N(0, G) (``BLR_RMHMC.m``).  This framework follows the correct MATLAB
    contract: momentum ~ N(0, G).
    """
    d = chol_l.shape[-1]
    eps = jax.random.normal(key, (*shape, *chol_l.shape[:-2], d), dtype=chol_l.dtype)
    return jnp.einsum("...ab,...b->...a", chol_l, eps, precision=PRECISION)

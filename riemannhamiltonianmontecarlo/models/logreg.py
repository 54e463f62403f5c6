"""Bayesian logistic regression with closed-form manifold geometry.

Statistical contract (matching the reference):

* log joint  ``L(w) = t^T X w - sum_n log(1 + exp(x_n^T w)) + log N(w; 0, alpha I)``
  with ``alpha = 100`` (reference ``code/hmc.py:31-34``, ``code/rmhmc.py:19``).
* gradient   ``X^T (t - sigma(Xw)) - w / alpha``   (``code/hmc.py:53``).
* Fisher metric ``G(w) = X^T diag(v) X + I / alpha``, ``v = p (1 - p)``,
  ``p = sigma(Xw)``  (``code/rmhmc.py:50-57``).
* metric derivative ``dG/dw_d = X^T diag(v (1 - 2p) X[:, d]) X``
  (``code/rmhmc.py:63-77``).

Redesign of the derivative algebra: the reference materializes
the dense (D, D, D) tensor ``InvG @ dG_d`` every step -- O(N D^3 + D^4)
work.  Because ``dG_d = sum_n c_{nd} x_n x_n^T`` with rank-one structure
(``c_{nd} = v_n (1 - 2 p_n) X_{nd}``), every contraction a manifold
sampler needs reduces to matmuls over the data axis:

* ``u^T dG_d v        = sum_n c_{nd} (x_n.u)(x_n.v)``
* ``tr(M dG_d)        = sum_n c_{nd} (x_n^T M x_n)``
* ``sum_e (M dG_e M)[:, e] = sum_n c_n' s_n M x_n``  with
  ``s_n = x_n^T M x_n``

-- all O(N D^2) per chain and batched over chains as (chains, N) x (N, D)
matmuls.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

# MH acceptance compares log densities to O(1), so every contraction feeding
# logp / grad / G runs at full f32 precision; the GPU default for f32
# matmuls is TF32, which keeps about three decimal digits.
PRECISION = jax.lax.Precision.HIGHEST


class ManifoldState(NamedTuple):
    """Everything a manifold kernel needs at a position, in one fused pass."""

    logp: Array  # (...,)
    grad: Array  # (..., D)
    metric: Array  # (..., D, D)
    cache: Array  # dG cache; for BLR the (..., N) weights v * (1 - 2p)


@dataclasses.dataclass(frozen=True)
class LogisticRegression:
    """Bayesian logistic regression model over a fixed design matrix.

    Attributes:
      X: (N, D) design matrix (bias column / basis expansion already applied).
      t: (N,) binary labels in {0, 1}.
      alpha: prior variance (reference uses 100, ``code/rmhmc.py:19``).
    """

    X: Array
    t: Array
    alpha: float = 100.0
    # Row-validity mask (1 real, 0 padding), or None when no padding.  Set
    # by ``with_sharding`` so N can round up to a multiple of the mesh
    # axis; a padded row has x_n = 0 and t_n = 0, which contributes zero
    # to grad / G / dG by construction and is masked out of logp's
    # ``softplus(0) = log 2`` term below.
    mask: Array | None = None

    def __post_init__(self):
        object.__setattr__(self, "X", jnp.asarray(self.X))
        object.__setattr__(self, "t", jnp.asarray(self.t).reshape(-1))
        # Outer-product feature matrix F[n, d*D+e] = X[n,d] X[n,e] (N, D^2),
        # precomputed once (~0.6 MB for australian).  Every weighted
        # second-moment contraction then becomes ONE dense GEMM:
        #   G(w)      = reshape(v @ F) + I/alpha            (C,N)x(N,D^2)
        #   s_n = x_n^T M x_n  ->  s = M_flat @ F^T         (C,D^2)x(D^2,N)
        # Without it, XLA's pairwise einsum lowering materializes a
        # (C, N, D) intermediate (~170 MB at C=4096 for australian) for
        # every metric build and dG trace -- tens of times per RMHMC
        # step, which made the BLR kernel HBM-bandwidth-bound (the
        # round-2..4 "latency-bound" label was this traffic).
        x = self.X
        n, d = x.shape
        f = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
        object.__setattr__(self, "_outer_features", f)

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def num_data(self) -> int:
        return self.X.shape[0]

    def with_sharding(self, mesh, axis: str = "data"):
        """Copy of the model with the design matrix row-sharded over
        ``axis`` of ``mesh`` -- the tensor-parallel data axis
        (SURVEY.md section 2.4 TP row).

        Every contraction over n in this file (logits ``w X^T``, gradient
        ``resid X``, metric build ``X^T diag(v) X``, the dG reductions)
        lowers under GSPMD to per-device partial products + a ``psum``
        over ``axis``: each device stores N/k rows of X and only
        (chains, D)-sized activations cross between devices.  N is zero-padded up
        to a multiple of the axis size; padded rows have x_n = 0, t_n = 0
        (zero contribution to grad / G / dG) and a 0 ``mask`` entry that
        removes their ``softplus(0)`` bias from logp, so results are
        bitwise-comparable to the unsharded model up to reduction order.
        """
        from jax.sharding import NamedSharding, PartitionSpec

        k = mesh.shape[axis]
        n = self.num_data
        n_pad = (-n) % k
        x_np = jnp.pad(self.X, ((0, n_pad), (0, 0)))
        t_np = jnp.pad(self.t, (0, n_pad))
        mask = jnp.pad(jnp.ones((n,), self.X.dtype), (0, n_pad))
        rows = NamedSharding(mesh, PartitionSpec(axis, None))
        vec = NamedSharding(mesh, PartitionSpec(axis))
        return dataclasses.replace(
            self,
            X=jax.device_put(x_np, rows),
            t=jax.device_put(t_np, vec),
            mask=jax.device_put(mask, vec),
        )

    # -- densities ---------------------------------------------------------

    def _logits(self, w: Array) -> Array:
        # (..., D) @ (D, N) -> (..., N).
        return jnp.matmul(w, self.X.T, precision=PRECISION)

    def log_prior(self, w: Array) -> Array:
        d = self.dim
        const = -0.5 * d * jnp.log(2.0 * jnp.pi * self.alpha)
        return const - 0.5 * jnp.sum(w * w, axis=-1) / self.alpha

    def _loglik(self, f: Array) -> Array:
        # f * t is already 0 on padded rows (f = x_n.w = 0); softplus(0)
        # = log 2 is not, so it is the one term that needs the mask.
        sp = jax.nn.softplus(f)
        if self.mask is not None:
            sp = sp * self.mask
        return jnp.sum(f * self.t, axis=-1) - jnp.sum(sp, axis=-1)

    def logp(self, w: Array) -> Array:
        return self._loglik(self._logits(w)) + self.log_prior(w)

    def grad(self, w: Array) -> Array:
        f = self._logits(w)
        resid = self.t - jax.nn.sigmoid(f)  # (..., N)
        return jnp.matmul(resid, self.X, precision=PRECISION) - w / self.alpha

    def logp_and_grad(self, w: Array) -> tuple[Array, Array]:
        f = self._logits(w)
        logp = self._loglik(f) + self.log_prior(w)
        resid = self.t - jax.nn.sigmoid(f)
        return logp, jnp.matmul(resid, self.X, precision=PRECISION) - w / self.alpha

    # -- manifold geometry -------------------------------------------------

    def _weights(self, w: Array) -> tuple[Array, Array, Array]:
        p = jax.nn.sigmoid(self._logits(w))
        v = p * (1.0 - p)
        c = v * (1.0 - 2.0 * p)
        return p, v, c

    def _metric_from_v(self, v: Array) -> Array:
        # G = X^T diag(v) X + I/alpha as one (C, N) x (N, D^2) GEMM over
        # the precomputed outer features (see __post_init__).
        d = self.dim
        g = jnp.matmul(v, self._outer_features, precision=PRECISION)
        g = g.reshape(*v.shape[:-1], d, d)
        eye = jnp.eye(d, dtype=g.dtype) / self.alpha
        return g + eye

    def metric(self, w: Array) -> Array:
        _, v, _ = self._weights(w)
        return self._metric_from_v(v)

    def manifold_state(self, w: Array) -> ManifoldState:
        """Fused logp + grad + G + dG weights (one logits matmul)."""
        f = self._logits(w)
        logp = self._loglik(f) + self.log_prior(w)
        p = jax.nn.sigmoid(f)
        grad = jnp.matmul(self.t - p, self.X, precision=PRECISION) - w / self.alpha
        v = p * (1.0 - p)
        c = v * (1.0 - 2.0 * p)
        return ManifoldState(logp, grad, self._metric_from_v(v), c)

    def dg_cache(self, w: Array) -> Array:
        """(..., N) weights c_n = v_n (1 - 2 p_n);  dG_d = X^T diag(c X[:,d]) X."""
        _, _, c = self._weights(w)
        return c

    def dg_bilinear(self, w: Array, u: Array, v: Array, *, cache: Array | None = None) -> Array:
        """[u^T dG_d v]_d = X^T (c * (Xu) * (Xv))."""
        c = self.dg_cache(w) if cache is None else cache
        xu = jnp.matmul(u, self.X.T, precision=PRECISION)
        xv = xu if v is u else jnp.matmul(v, self.X.T, precision=PRECISION)
        return jnp.matmul(c * xu * xv, self.X, precision=PRECISION)

    def dg_trace(self, w: Array, m: Array, *, cache: Array | None = None) -> Array:
        """[tr(M dG_d)]_d = X^T (c * s),  s_n = x_n^T M x_n."""
        c = self.dg_cache(w) if cache is None else cache
        s = self.quadratic_forms(m)  # (..., N)
        return jnp.matmul(c * s, self.X, precision=PRECISION)

    def dg_dotted(self, w: Array, m: Array, *, cache: Array | None = None) -> Array:
        """[sum_e (M dG_e M)[:, e]] = ((c * s) @ X) M,  s_n = x_n^T M x_n.

        M is symmetric (it is G^{-1} or a product thereof), so the final
        contraction with X M associates as a (..., D) matvec with M --
        no (..., N, D) intermediate.
        """
        c = self.dg_cache(w) if cache is None else cache
        s = self.quadratic_forms(m)
        csx = jnp.matmul(c * s, self.X, precision=PRECISION)  # (..., D)
        return jnp.einsum("...d,...de->...e", csx, m, precision=PRECISION)

    def quadratic_forms(self, m: Array) -> Array:
        """s_n = x_n^T M x_n, batched: one (..., D^2) x (D^2, N) GEMM over
        the precomputed outer features (no (..., N, D) intermediate)."""
        d = self.dim
        m_flat = m.reshape(*m.shape[:-2], d * d)
        return jnp.matmul(m_flat, self._outer_features.T, precision=PRECISION)

    # -- IWLS helpers (``code/iwls.py:28-35``) ------------------------------

    def iwls_proposal(self, w: Array) -> tuple[Array, Array]:
        """One Newton/IWLS step: proposal covariance and mean.

        cov  = (I/alpha + X^T diag(v) X)^{-1} = G(w)^{-1}
        mean = cov @ X^T diag(v) z,   z = Xw + (t - p)/v
        (reference ``code/iwls.py:28-35``; note mean simplifies to
        cov @ (X^T diag(v) X w + X^T (t - p)).)
        """
        f = self._logits(w)
        p = jax.nn.sigmoid(f)
        v = p * (1.0 - p)
        g = self._metric_from_v(v)
        rhs = jnp.matmul(v * f + (self.t - p), self.X, precision=PRECISION)  # (..., D)
        cov = jnp.linalg.inv(g)
        mean = jnp.einsum("...ab,...b->...a", cov, rhs, precision=PRECISION)
        return mean, cov

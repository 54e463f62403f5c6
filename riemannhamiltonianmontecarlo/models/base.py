"""Model interface for manifold MCMC.

The reference inlines the model math (log joint, gradient, Fisher metric
G(theta), dG/dtheta) inside every sampler file (e.g. BLR joint at
``code/hmc.py:31-34``, metric at ``code/rmhmc.py:50-57``, metric derivative
at ``code/rmhmc.py:63-77``).  Here the model is a first-class object that
samplers consume, and every method is *batched*: positions carry arbitrary
leading (chain) axes, so kernels run thousands of chains in lockstep as
batched array ops without `vmap` overhead in the hot path.

Manifold samplers (RMHMC / mMALA) never need the dense third-order tensor
dG (the reference materializes a (D, D, D) array per step,
``code/rmhmc.py:64-77``).  They only need three contractions, which for the
models in this framework have closed forms that are O(N D^2) instead of
O(N D^3):

* ``dg_bilinear(w, u, v)[d]  = u^T (dG/dw_d) v``
* ``dg_trace(w, M)[d]        = tr(M dG/dw_d)``          (M symmetric)
* ``dg_dotted(w, M)[d]       = sum_e (M (dG/dw_e) M)[d, e]``  (mMALA drift)

Models without closed forms can derive everything from ``logp`` /
``metric`` via :func:`autodiff_manifold` (jacfwd-based, fine for small D
such as the FitzHugh-Nagumo 3-parameter posterior).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

import jax
import jax.numpy as jnp

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST


@runtime_checkable
class Model(Protocol):
    """Minimal interface: an unnormalized log density and its gradient."""

    dim: int

    def logp(self, w: Array) -> Array:
        """Log joint density.  w: (..., D) -> (...)."""
        ...

    def grad(self, w: Array) -> Array:
        """Gradient of ``logp``.  w: (..., D) -> (..., D)."""
        ...


@runtime_checkable
class ManifoldModel(Model, Protocol):
    """Adds the Fisher-metric interface needed by RMHMC / mMALA.

    ``cache`` is an opaque per-position object from :meth:`dg_cache` that
    lets the dG contractions reuse work across the fixed-point iterations
    of a generalized-leapfrog step (for BLR it is the (..., N) weight
    vector ``v (1 - 2p)``; for autodiff models the dense (..., D, D, D)
    metric jacobian).
    """

    def metric(self, w: Array) -> Array:
        """Fisher metric G(w).  (..., D) -> (..., D, D), symmetric PD."""
        ...

    def dg_cache(self, w: Array):
        """Precompute whatever the dG contractions need at ``w``."""
        ...

    def dg_bilinear(self, w: Array, u: Array, v: Array, *, cache=None) -> Array:
        """[u^T dG_d v]_d.  (..., D) x (..., D) x (..., D) -> (..., D)."""
        ...

    def dg_trace(self, w: Array, m: Array, *, cache=None) -> Array:
        """[tr(M dG_d)]_d for symmetric M.  (..., D, D) -> (..., D)."""
        ...

    def dg_dotted(self, w: Array, m: Array, *, cache=None) -> Array:
        """[sum_e (M dG_e M)[d, e]]_d  (mMALA curvature drift term)."""
        ...


@dataclasses.dataclass(frozen=True)
class FunctionModel:
    """Wrap a plain ``logp`` callable into a :class:`Model` via autodiff."""

    dim: int
    logp_fn: Callable[[Array], Array]

    def logp(self, w: Array) -> Array:
        if w.ndim == 1:
            return self.logp_fn(w)
        flat = w.reshape(-1, self.dim)
        return jax.vmap(self.logp_fn)(flat).reshape(w.shape[:-1])

    def grad(self, w: Array) -> Array:
        g = jax.grad(self.logp_fn)
        if w.ndim == 1:
            return g(w)
        flat = w.reshape(-1, self.dim)
        return jax.vmap(g)(flat).reshape(w.shape)


def autodiff_manifold(model: Model, metric_fn: Callable[[Array], Array]):
    """Derive the dG contractions of a :class:`ManifoldModel` by autodiff.

    ``metric_fn`` maps a single position (D,) to G (D, D).  The full
    jacobian dG (D, D, D) is built with ``jax.jacfwd`` and contracted --
    O(D^3) storage per chain, acceptable only for small D (the reference
    does the same dense build even for D=25, ``code/rmhmc.py:64``).

    Returns a frozen dataclass implementing :class:`ManifoldModel` by
    delegation.
    """

    def _jac_single(w):  # (D,) -> (D, D, D): jac[d] = dG/dw_d
        return jnp.moveaxis(jax.jacfwd(metric_fn)(w), -1, 0)

    def _batched(fn, w, *args):
        if w.ndim == 1:
            return fn(w, *args)
        lead = w.shape[:-1]
        flat = [a.reshape((-1,) + a.shape[len(lead):]) for a in (w, *args)]
        out = jax.vmap(fn)(*flat)
        return out.reshape(lead + out.shape[1:])

    @dataclasses.dataclass(frozen=True)
    class _AutodiffManifold:
        dim: int = model.dim

        def logp(self, w):
            return model.logp(w)

        def grad(self, w):
            return model.grad(w)

        def metric(self, w):
            return _batched(metric_fn, w)

        def dg_cache(self, w):
            """Dense metric jacobian (..., D, D, D), reused across calls."""
            return _batched(_jac_single, w)

        def _cache(self, w, cache):
            return self.dg_cache(w) if cache is None else cache

        def dg_bilinear(self, w, u, v, *, cache=None):
            jac = self._cache(w, cache)
            return jnp.einsum("...dab,...a,...b->...d", jac, u, v, precision=_PREC)

        def dg_trace(self, w, m, *, cache=None):
            jac = self._cache(w, cache)
            return jnp.einsum("...dab,...ba->...d", jac, m, precision=_PREC)

        def dg_dotted(self, w, m, *, cache=None):
            jac = self._cache(w, cache)
            return jnp.einsum("...ia,...eab,...be->...i", m, jac, m, precision=_PREC)

    return _AutodiffManifold()

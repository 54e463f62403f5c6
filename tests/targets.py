"""Shared test targets with known ground truth."""

import jax.numpy as jnp
import numpy as np

from riemannhamiltonianmontecarlo.models.logreg import ManifoldState


class ConstantMetricGaussian:
    """Gaussian N(mu, Sigma) whose Fisher metric is the (constant) precision.

    With a constant metric the generalized leapfrog collapses to
    preconditioned HMC and all dG contractions vanish -- an exact oracle
    for the RMHMC/mMALA machinery.
    """

    def __init__(self, mean, cov):
        self.mean = jnp.asarray(mean, jnp.float32)
        cov = np.asarray(cov, np.float64)
        self.cov = cov
        self.prec = jnp.asarray(np.linalg.inv(cov), jnp.float32)
        self.dim = self.mean.shape[0]

    def logp(self, w):
        d = w - self.mean
        return -0.5 * jnp.einsum("...a,ab,...b->...", d, self.prec, d)

    def grad(self, w):
        return -jnp.einsum("ab,...b->...a", self.prec, w - self.mean)

    def logp_and_grad(self, w):
        return self.logp(w), self.grad(w)

    def metric(self, w):
        return jnp.broadcast_to(self.prec, w.shape[:-1] + (self.dim, self.dim))

    def manifold_state(self, w):
        return ManifoldState(self.logp(w), self.grad(w), self.metric(w), self.dg_cache(w))

    def dg_cache(self, w):
        return jnp.zeros(w.shape[:-1] + (1,), w.dtype)

    def dg_bilinear(self, w, u, v, *, cache=None):
        return jnp.zeros_like(w)

    def dg_trace(self, w, m, *, cache=None):
        return jnp.zeros_like(w)

    def dg_dotted(self, w, m, *, cache=None):
        return jnp.zeros_like(w)

"""FitzHugh-Nagumo ODE parameter inference (paper sec. 11).

Model (``Matlab_ODEs/RunFHN_RMHMC.m:35-52``, ``Models/FitzHughNagumo.m``):

* dynamics dV/dt = c (V - V^3/3 + R), dR/dt = -(V - a + b R)/c;
* data: both species observed at 200 equispaced times on [0, 20], initial
  values (-1, 1), true parameters (a, b, c) = (0.2, 0.2, 3), iid Gaussian
  noise sigma = 0.5;
* likelihood: Gaussian with *known* noise variance (``ODE_RMHMC.m:68``);
* prior: theta_i ~ Gamma(shape 1, scale 3) (``Priors/ModelParameterPrior.m``),
  support theta > 0 (negative proposals get density zero -> reject);
* Fisher metric G_ij = sum_species S_i^T S_j / sigma^2 + prior curvature
  diag(2 / theta^2) (``ODE_RMHMC.m:126-146``);
* metric derivatives from second-order sensitivities (``:155-177``).

Redesign: the reference integrates hand-derived sensitivity
ODEs -- an 8-dim system for S (``FitzHughNagumoSens1.m``) and a 20-dim
system for S2 (``FitzHughNagumoSens2.m``) -- with adaptive ode45.  Here
the integrator is a fixed-step RK4 ``lax.scan`` (static shapes, lockstep
across chains) and ALL sensitivities come from ``jax.jacfwd`` through
the integrator: first order for grad/metric, jacfwd-of-metric for dG.
This reproduces the same quantities without 600 lines of hand algebra.

Reference quirks *not* reproduced (documented; correctness unaffected
because MH accepts on the exact H): the MATLAB prior curvature in G uses
Gamma(3,1) while the density is Gamma(1,3) (we keep their metric
formula, which is merely a preconditioner choice), and their dG adds the
full prior-diagonal to every component k (``ODE_RMHMC.m:175``) -- we use
the exact jacfwd of the metric instead.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from riemannhamiltonianmontecarlo.models.base import autodiff_manifold
from riemannhamiltonianmontecarlo.models.logreg import ManifoldState

Array = jax.Array
_PREC = jax.lax.Precision.HIGHEST


def fhn_rhs(state: Array, theta: Array) -> Array:
    """FitzHugh-Nagumo vector field (``Models/FitzHughNagumo.m``)."""
    v, r = state[..., 0], state[..., 1]
    a, b, c = theta[..., 0], theta[..., 1], theta[..., 2]
    dv = c * (v - v**3 / 3.0 + r)
    dr = -(v - a + b * r) / c
    return jnp.stack([dv, dr], axis=-1)


def integrate_rk4(
    theta: Array,
    *,
    t0: float = 0.0,
    t1: float = 20.0,
    num_obs: int = 200,
    substeps: int = 5,
    init: tuple[float, float] = (-1.0, 1.0),
) -> Array:
    """States at the ``num_obs`` observation times, fixed-step RK4.

    theta: (3,) -> (num_obs, 2).  Differentiable (jacfwd-safe scan).
    """
    dt_obs = (t1 - t0) / (num_obs - 1)
    h = dt_obs / substeps
    y0 = jnp.asarray(init, theta.dtype)

    def rk4_step(y, _):
        k1 = fhn_rhs(y, theta)
        k2 = fhn_rhs(y + 0.5 * h * k1, theta)
        k3 = fhn_rhs(y + 0.5 * h * k2, theta)
        k4 = fhn_rhs(y + h * k3, theta)
        y = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        return y, None

    def obs_step(y, _):
        y, _ = jax.lax.scan(rk4_step, y, None, length=substeps)
        return y, y

    _, traj = jax.lax.scan(obs_step, y0, None, length=num_obs - 1)
    return jnp.concatenate([y0[None], traj], axis=0)


def generate_data(seed: int = 1, noise_sd: float = 0.5, **kwargs):
    """Simulate noisy observations at the true parameters (RunFHN_RMHMC.m:35-52)."""
    theta_true = jnp.asarray([0.2, 0.2, 3.0])
    clean = np.asarray(integrate_rk4(theta_true, substeps=20, **kwargs))
    rng = np.random.default_rng(seed)
    return clean + rng.normal(size=clean.shape) * noise_sd, clean


@dataclasses.dataclass(frozen=True)
class FHNModel:
    """Posterior over (a, b, c) given noisy FHN trajectories.

    Batched via vmap in :func:`autodiff_manifold`-style; D = 3.
    """

    data: Array  # (num_obs, 2)
    noise_sd: float = 0.5
    substeps: int = 5
    gamma_scale: float = 3.0  # prior Gamma(1, 3)

    dim: int = 3

    def __post_init__(self):
        object.__setattr__(self, "data", jnp.asarray(self.data))

    # -- single-position core ------------------------------------------------

    def _solve(self, theta: Array) -> Array:
        return integrate_rk4(
            theta, num_obs=self.data.shape[0], substeps=self.substeps
        )

    def _logp_single(self, theta: Array) -> Array:
        traj = self._solve(theta)
        var = self.noise_sd**2
        loglik = -0.5 * jnp.sum((traj - self.data) ** 2) / var
        # Gamma(1, 3): log p = -theta/3 (support theta > 0)
        logprior = -jnp.sum(theta) / self.gamma_scale
        valid = jnp.all(theta > 0.0) & jnp.all(jnp.isfinite(traj))
        return jnp.where(valid, loglik + logprior, -jnp.inf)

    def _metric_single(self, theta: Array) -> Array:
        """G = sum_s S_s^T S_s / sigma^2 + diag(2/theta^2) (ODE_RMHMC.m:126-146)."""
        sens = jax.jacfwd(self._solve)(theta)  # (num_obs, 2, 3)
        var = self.noise_sd**2
        g = jnp.einsum("tsi,tsj->ij", sens, sens, precision=_PREC) / var
        return g + jnp.diag(2.0 / theta**2)

    # -- batched interface ---------------------------------------------------

    def _batched(self, fn, theta: Array, *args):
        if theta.ndim == 1:
            return fn(theta, *args)
        lead = theta.shape[:-1]
        flat = [a.reshape((-1,) + a.shape[len(lead):]) for a in (theta, *args)]
        out = jax.vmap(fn)(*flat)
        return out.reshape(lead + out.shape[1:])

    def logp(self, theta: Array) -> Array:
        return self._batched(self._logp_single, theta)

    def grad(self, theta: Array) -> Array:
        g = jax.grad(self._logp_single)

        def safe(th):
            out = g(th)
            return jnp.where(jnp.isfinite(out), out, 0.0)

        return self._batched(safe, theta)

    def logp_and_grad(self, theta: Array) -> tuple[Array, Array]:
        return self.logp(theta), self.grad(theta)

    def metric(self, theta: Array) -> Array:
        return self._batched(self._metric_single, theta)

    def manifold_state(self, theta: Array) -> ManifoldState:
        return ManifoldState(
            self.logp(theta), self.grad(theta), self.metric(theta), self.dg_cache(theta)
        )

    def _manifold(self):
        return autodiff_manifold(self, self._metric_single)

    def dg_cache(self, theta: Array):
        return self._manifold().dg_cache(theta)

    def dg_bilinear(self, theta, u, v, *, cache=None):
        return self._manifold().dg_bilinear(theta, u, v, cache=cache)

    def dg_trace(self, theta, m, *, cache=None):
        return self._manifold().dg_trace(theta, m, cache=cache)

    def dg_dotted(self, theta, m, *, cache=None):
        return self._manifold().dg_dotted(theta, m, cache=cache)

    def iwls_proposal(self, theta):
        raise NotImplementedError("IWLS is a logistic-regression sampler")

"""Stochastic volatility model (Girolami & Calderhead sec. 9).

Model (``StochVol_RMHMC.m:8-31``): latent AR(1) log-volatilities
``x_1 ~ N(0, sigma^2/(1-phi^2))``, ``x_{t+1} = phi x_t + N(0, sigma^2)``,
observations ``y_t = beta eps_t exp(x_t / 2)``; hyperparameters
theta = (beta, sigma, phi) with priors (``StochVol_RMHMC.m:228-229``):
beta ~ Exp(1)-style ``-beta``, sigma^2 with ``-0.5/(2 sigma^2) - 6 log
sigma^2 + log sigma``, and ``(phi+1)/2 ~ Beta(20, 1.5)``.

Two conditional targets (two-block Gibbs, SURVEY.md 3.5):

* **latent block** x | theta: log density ``StochVol_RMHMC.m:115``;
  gradient via the banded AR(1) recurrence (``:122-130``), equivalently
  ``s - iC x`` with iC the AR(1) precision; *constant* tridiagonal
  metric G = iC + I/2 (``:132-141``) -> exact leapfrog, batched
  tridiagonal factor/solve in ``ops.tridiag``;
* **hyper block** theta | x, sampled in the transformed coordinates
  theta~ = (beta, log sigma, atanh phi) with the Jacobian
  ``log(sigma (1 - phi^2))`` added to the target (``:227,412``),
  analytic 3x3 Fisher + prior metric (``:245-256``).

Deviation from the reference, documented: the MATLAB hand-coded
hyper-gradient constants are inconsistent with its own Hamiltonian
(d/dlog sigma off by +1, the phi-prior drift doubled -- compare
``:232-237`` against the density at ``:226-229``).  Since the gradient
only shapes trajectories while MH accepts on the exact H, this costs
acceptance, not correctness; this implementation uses the exact autodiff
gradient of the same target, keeping the identical density, metric and
acceptance rule.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

REFERENCE_MAT = Path(
    "/root/reference/code/authors_code/Stoch_Vol/RM-HMC/StochVolData1.mat"
)


def generate_data(
    seed: int = 0, num_obs: int = 2000, beta: float = 0.65, sigma: float = 0.15, phi: float = 0.98
) -> tuple[np.ndarray, np.ndarray]:
    """Simulate (y, x_true) exactly as ``StochVol_RMHMC.m:16-31``."""
    rng = np.random.default_rng(seed)
    x = np.zeros(num_obs)
    x[0] = rng.normal(0.0, sigma / np.sqrt(1 - phi**2))
    for n in range(num_obs - 1):
        x[n + 1] = phi * x[n] + rng.normal(0.0, sigma)
    y = beta * rng.normal(size=num_obs) * np.exp(x / 2)
    return y, x


def load_data(path: str | Path | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Load the authors' simulated dataset (StochVolData1.mat) if present."""
    p = Path(path) if path is not None else REFERENCE_MAT
    if not p.exists():
        return generate_data()
    from scipy.io import loadmat

    data = loadmat(p)
    return data["y"].reshape(-1), data["Truex"].reshape(-1)


@dataclasses.dataclass(frozen=True)
class StochVolModel:
    """Conditional densities/geometry for the two-block sampler.

    Hyperparameters are handled in transformed coordinates
    theta~ = (beta, log sigma, atanh phi) throughout.
    """

    y: Array  # (T,)

    def __post_init__(self):
        object.__setattr__(self, "y", jnp.asarray(self.y))

    @property
    def num_obs(self) -> int:
        return self.y.shape[0]

    # -- coordinate transform ------------------------------------------------

    @staticmethod
    def constrain(theta_t: Array) -> tuple[Array, Array, Array]:
        """theta~ -> (beta, sigma, phi)."""
        beta = theta_t[..., 0]
        sigma = jnp.exp(theta_t[..., 1])
        phi = jnp.tanh(theta_t[..., 2])
        return beta, sigma, phi

    @staticmethod
    def unconstrain(beta: Array, sigma: Array, phi: Array) -> Array:
        return jnp.stack([beta, jnp.log(sigma), jnp.arctanh(phi)], axis=-1)

    # -- latent block --------------------------------------------------------

    def latent_logp(self, x: Array, theta_t: Array) -> Array:
        """log p(x, y | theta) up to consts (``StochVol_RMHMC.m:115``).

        x: (..., T), theta_t: (..., 3) -> (...,).
        """
        beta, sigma, phi = self.constrain(theta_t)
        beta = beta[..., None]
        sigma = sigma[..., None]
        phi = phi[..., None]
        y2 = self.y**2
        innov = x[..., 1:] - phi * x[..., :-1]
        return (
            -(x[..., 0] ** 2) * (1.0 - phi[..., 0] ** 2) / (2.0 * sigma[..., 0] ** 2)
            - jnp.sum(x / 2.0 + y2 / (2.0 * beta**2 * jnp.exp(x)), axis=-1)
            - jnp.sum(innov**2, axis=-1) / (2.0 * sigma[..., 0] ** 2)
        )

    def latent_grad(self, x: Array, theta_t: Array) -> Array:
        """d latent_logp / dx = s - iC x  (``StochVol_RMHMC.m:121-130``)."""
        beta, sigma, phi = self.constrain(theta_t)
        beta = beta[..., None]
        y2 = self.y**2
        s = -0.5 + y2 / (2.0 * beta**2 * jnp.exp(x))
        diag, off = self.ar1_precision(theta_t)
        from riemannhamiltonianmontecarlo.ops import tridiag

        return s - tridiag.matvec(diag, off, x)

    def ar1_precision(self, theta_t: Array) -> tuple[Array, Array]:
        """AR(1) precision iC as (diag (..., T), off (..., T-1))
        (``StochVol_RMHMC.m:129-135``: iC(1,1)=iC(T,T)=1/s^2, interior
        (1+phi^2)/s^2, off-diagonals -phi/s^2)."""
        _, sigma, phi = self.constrain(theta_t)
        t = self.num_obs
        inv_s2 = 1.0 / sigma**2
        interior = (1.0 + phi**2) * inv_s2
        ends = inv_s2
        idx = jnp.arange(t)
        is_end = (idx == 0) | (idx == t - 1)
        diag = jnp.where(is_end, ends[..., None], interior[..., None])
        off = jnp.broadcast_to(
            (-phi * inv_s2)[..., None], theta_t.shape[:-1] + (t - 1,)
        )
        return diag, off

    def latent_metric(self, theta_t: Array) -> tuple[Array, Array]:
        """G = iC + I/2 (constant in x; ``StochVol_RMHMC.m:137-139``)."""
        diag, off = self.ar1_precision(theta_t)
        return diag + 0.5, off

    # -- hyper block (transformed coordinates) -------------------------------

    def hyper_logp(self, theta_t: Array, x: Array) -> Array:
        """log p(theta | x, y) in theta~ coords: LJL + prior + Jacobian.

        LJL ``StochVol_RMHMC.m:226``, prior ``:229``, Jacobian
        ``log(sigma (1-phi^2))`` ``:227``.
        """
        beta, sigma, phi = self.constrain(theta_t)
        t = self.num_obs
        y2 = self.y**2
        b = beta[..., None]
        innov = x[..., 1:] - phi[..., None] * x[..., :-1]
        ljl = (
            -jnp.sum(x / 2.0, axis=-1)
            - t * jnp.log(beta)
            - jnp.sum(y2 / (2.0 * b**2 * jnp.exp(x)), axis=-1)
            + 0.5 * jnp.log(1.0 - phi**2)
            - jnp.log(sigma)
            - x[..., 0] ** 2 * (1.0 - phi**2) / (2.0 * sigma**2)
            - (t - 1) * jnp.log(sigma)
            - jnp.sum(innov**2, axis=-1) / (2.0 * sigma**2)
        )
        prior = (
            -beta
            - 0.5 / (2.0 * sigma**2)
            - 6.0 * jnp.log(sigma**2)
            + jnp.log(sigma)
            + 19.0 * jnp.log((phi + 1.0) / 2.0)
            + 0.5 * jnp.log((1.0 - phi) / 2.0)
        )
        jacobian = jnp.log(sigma) + jnp.log(1.0 - phi**2)
        return ljl + prior + jacobian

    def hyper_metric(self, theta_t: Array) -> Array:
        """3x3 Fisher + prior metric in theta~ coords (``:245-256``)."""
        beta, sigma, phi = self.constrain(theta_t)
        t = self.num_obs
        z = jnp.zeros_like(beta)
        g00 = 2.0 * t / beta**2
        g11 = 2.0 * t + 1.0 / sigma**2  # Fisher 2T minus prior (-1/sigma^2)
        g12 = 2.0 * phi
        g22 = (
            2.0 * phi**2
            - (t - 1) * (phi**2 - 1.0)
            + 39.0 * (1.0 - phi**2)  # minus prior (-38-1)(1-phi^2)
        )
        row0 = jnp.stack([g00, z, z], axis=-1)
        row1 = jnp.stack([z, g11, g12], axis=-1)
        row2 = jnp.stack([z, g12, g22], axis=-1)
        return jnp.stack([row0, row1, row2], axis=-2)

    def hyper_manifold(self, x: Array):
        """A ManifoldModel view of theta~ | x for the RMHMC kernel.

        Gradient by exact autodiff of ``hyper_logp`` (see module
        docstring); dG by jacfwd of the analytic metric (D=3: dense is
        trivially cheap -- the reference also materializes the full
        dGdParas there, ``:265-277``).
        """
        from riemannhamiltonianmontecarlo.models.base import FunctionModel, autodiff_manifold
        from riemannhamiltonianmontecarlo.models.logreg import ManifoldState

        model = self

        class _Hyper:
            dim = 3

            def logp(self, th):
                lead = th.shape[:-1]
                xx = jnp.broadcast_to(x, lead + x.shape[-1:]) if x.ndim == 1 else x
                return model.hyper_logp(th, xx)

            def grad(self, th):
                grad_fn = jax.grad(model.hyper_logp)
                if th.ndim == 1:
                    return grad_fn(th, x)
                flat_th = th.reshape(-1, 3)
                if x.ndim == 1:
                    g = jax.vmap(lambda a: grad_fn(a, x))(flat_th)
                else:
                    flat_x = x.reshape(-1, x.shape[-1])
                    g = jax.vmap(grad_fn)(flat_th, flat_x)
                return g.reshape(th.shape)

        base = _Hyper()
        mani = autodiff_manifold(base, lambda th: model.hyper_metric(th))

        class _HyperManifold:
            dim = 3
            logp = staticmethod(base.logp)
            grad = staticmethod(base.grad)

            @staticmethod
            def logp_and_grad(th):
                return base.logp(th), base.grad(th)

            metric = staticmethod(mani.metric)
            dg_cache = staticmethod(mani.dg_cache)
            dg_bilinear = staticmethod(mani.dg_bilinear)
            dg_trace = staticmethod(mani.dg_trace)
            dg_dotted = staticmethod(mani.dg_dotted)

            @staticmethod
            def manifold_state(th):
                return ManifoldState(
                    base.logp(th), base.grad(th), mani.metric(th), mani.dg_cache(th)
                )

        return _HyperManifold()

"""Log-Gaussian Cox point process on an N x N grid (paper sec. 10).

Model (``Log_Gaussian_Cox/RMHMC/LGC_RMHMC_LV.m``):

* hyperparameters s = 1.91, b = 1/33, mu = log(126) - s/2, m = 1/N^2
  (``:21-25``);
* GP prior covariance over unit-square grid coordinates
  ``Sigma_ij = s exp(-dist_ij / (b N))``  (``:58-79``);
* Poisson-count log joint ``y^T x - sum m e^x - (x-mu)^T Sigma^{-1}
  (x-mu)/2``  (``:86``);
* **constant-metric approximation**: G = Sigma^{-1} + diag(m exp(mu +
  diag Sigma)) -- the Fisher metric evaluated at the prior mean
  (``:95-101``) -- making the RMHMC leapfrog exact/explicit with a fixed
  dense preconditioner (the log-det and trace terms drop, ``:154-196``).

D = N^2 = 4096 is the framework's "long-context" workload (SURVEY.md
section 5): one-time O(D^3) dense factorizations, O(C D^2) matvecs per
leapfrog step batched over chains.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

REFERENCE_MAT = Path(
    "/root/reference/code/authors_code/Log_Gaussian_Cox/RMHMC/TestData64.mat"
)
_PREC = jax.lax.Precision.HIGHEST


def grid_distances(n: int) -> np.ndarray:
    """Pairwise Euclidean distances of the unit-square grid (n^2, n^2)."""
    r = np.linspace(0.0, 1.0, n)
    xs, ys = np.meshgrid(r, r)
    coords = np.stack([xs.ravel(), ys.ravel()], axis=1)  # (n^2, 2)
    diff = coords[:, None, :] - coords[None, :, :]
    return np.sqrt((diff**2).sum(-1))


def grid_covariance(n: int, s: float, b: float) -> np.ndarray:
    """Sigma_ij = s exp(-||coord_i - coord_j|| / (b n)) on the unit square
    (``LGC_RMHMC_LV.m:58-79``; meshgrid order => row-major over (y, x))."""
    return s * np.exp(-grid_distances(n) / (b * n))


def generate_data(
    seed: int = 0, n: int = 64, s: float = 1.91, b: float = 1.0 / 33.0
) -> tuple[np.ndarray, np.ndarray]:
    """Simulate (y counts, x_true) from the model (known-truth pattern)."""
    rng = np.random.default_rng(seed)
    mu = np.log(126.0) - s / 2.0
    m = 1.0 / n**2
    sigma = grid_covariance(n, s, b)
    chol = np.linalg.cholesky(sigma + 1e-10 * np.eye(n * n))
    x = mu + chol @ rng.normal(size=n * n)
    y = rng.poisson(m * np.exp(x)).astype(np.float64)
    return y, x


def load_data(path: str | Path | None = None, n: int = 64):
    """The authors' TestData64.mat (fields Y counts, X latents) if present."""
    p = Path(path) if path is not None else REFERENCE_MAT
    if not p.exists():
        return generate_data(n=n)
    from scipy.io import loadmat

    data = loadmat(p)
    return data["Y"].reshape(-1), data["X"].reshape(-1)


@dataclasses.dataclass(frozen=True)
class LGCModel:
    """Latent-field posterior with precomputed dense GP algebra.

    All per-position methods are batched over leading chain axes.
    """

    y: Array  # (D,)
    n: int = 64
    s: float = 1.91
    b: float = 1.0 / 33.0

    def __post_init__(self):
        object.__setattr__(self, "y", jnp.asarray(self.y, jnp.float32))
        n, s = self.n, self.s
        mu = float(np.log(126.0) - s / 2.0)
        m = 1.0 / n**2
        sigma_np = grid_covariance(n, s, self.b)
        # One-time dense algebra in float64 on host (the reference uses
        # lightspeed chol2inv, ``:81``); results cast to f32 for the chip.
        sigma_inv_np = np.linalg.inv(sigma_np)
        g_np = sigma_inv_np + np.diag(m * np.exp(mu + np.diag(sigma_np)))
        chol_g_np = np.linalg.cholesky(g_np)
        inv_g_np = np.linalg.inv(g_np)
        object.__setattr__(self, "mu", mu)
        object.__setattr__(self, "m", m)
        object.__setattr__(self, "sigma_diag", jnp.asarray(np.diag(sigma_np), jnp.float32))
        object.__setattr__(self, "sigma_inv", jnp.asarray(sigma_inv_np, jnp.float32))
        object.__setattr__(self, "metric_chol", jnp.asarray(chol_g_np, jnp.float32))
        object.__setattr__(self, "metric_inv", jnp.asarray(inv_g_np, jnp.float32))

    @property
    def dim(self) -> int:
        return self.n * self.n

    def with_sharding(self, mesh, axis: str = "latent"):
        """Copy of the model with the dense (D, D) operators sharded over
        ``axis`` of ``mesh`` -- the framework's long-context axis
        (SURVEY.md section 5).

        The operators are sharded along their *row* (contraction)
        dimension, so the per-leapfrog matvecs ``p G^{-1}`` /
        ``x Sigma^{-1}`` lower under GSPMD to local partial products +
        ``psum`` over the latent axis: each device stores D/k rows
        (f32 D=4096: 64 MB per operator total instead of per device) and
        communicates only (C, D) activations.
        """
        import copy

        from jax.sharding import NamedSharding, PartitionSpec

        row = NamedSharding(mesh, PartitionSpec(axis, None))
        m = copy.copy(self)
        for name in ("sigma_inv", "metric_chol", "metric_inv"):
            object.__setattr__(m, name, jax.device_put(getattr(self, name), row))
        return m

    def logp(self, x: Array) -> Array:
        """y^T x - sum m e^x - (x-mu)^T Sigma^{-1} (x-mu)/2 (``:86``)."""
        centered = x - self.mu
        quad = jnp.einsum(
            "...a,ab,...b->...", centered, self.sigma_inv, centered, precision=_PREC
        )
        return (
            jnp.sum(x * self.y, axis=-1)
            - self.m * jnp.sum(jnp.exp(x), axis=-1)
            - 0.5 * quad
        )

    def metric_quad(self, delta: Array) -> Array:
        """delta^T G delta for the CONSTANT metric, without touching the
        dense G factors: G = Sigma^{-1} + diag(m e^{mu + diag Sigma})
        (``LGC_mMALA_LV.m:85-88``), so the quadratic form is the
        Sigma^{-1} form (reusing the operator the gradient already keeps
        on the device) plus a diagonal-weighted sum."""
        dvec = self.m * jnp.exp(self.mu + self.sigma_diag)
        quad = jnp.einsum(
            "...a,ab,...b->...", delta, self.sigma_inv, delta, precision=_PREC
        )
        return quad + jnp.sum(dvec * delta * delta, axis=-1)

    def grad(self, x: Array) -> Array:
        """y - m e^x - Sigma^{-1}(x - mu) (``:127``)."""
        centered = x - self.mu
        return (
            self.y
            - self.m * jnp.exp(x)
            - jnp.matmul(centered, self.sigma_inv, precision=_PREC)
        )

    def logp_and_grad(self, x: Array) -> tuple[Array, Array]:
        centered = x - self.mu
        sx = jnp.matmul(centered, self.sigma_inv, precision=_PREC)
        expx = jnp.exp(x)
        logp = (
            jnp.sum(x * self.y, axis=-1)
            - self.m * jnp.sum(expx, axis=-1)
            - 0.5 * jnp.sum(centered * sx, axis=-1)
        )
        return logp, self.y - self.m * expx - sx

    def logp_and_grad_fast(self, x: Array) -> tuple[Array, Array]:
        """Reduced-precision variant for IN-TRAJECTORY use only.

        The ``Sigma^{-1}`` matvec runs at DEFAULT precision, which on an
        NVIDIA GPU means TF32 (about three decimal digits).  Safe only
        where the caller re-evaluates the exact Hamiltonian at the
        trajectory endpoints before the MH test
        (samplers/phmc.py trajectory_precision) -- integration error then
        moves acceptance, not the stationary distribution.
        """
        centered = x - self.mu
        sx = jnp.matmul(centered, self.sigma_inv,
                        precision=jax.lax.Precision.DEFAULT)
        expx = jnp.exp(x)
        logp = (
            jnp.sum(x * self.y, axis=-1)
            - self.m * jnp.sum(expx, axis=-1)
            - 0.5 * jnp.sum(centered * sx, axis=-1)
        )
        return logp, self.y - self.m * expx - sx

    def prior_mean(self) -> Array:
        return jnp.full((self.dim,), self.mu, jnp.float32)

    # -- position-dependent manifold interface (mMALA, ``LGC_mMALA_LV.m``) --
    #
    # The exact Fisher metric is G(x) = Sigma^{-1} + diag(m e^x), so
    # dG_d = m e^{x_d} E_dd is rank-one *diagonal*: every contraction a
    # manifold sampler needs is elementwise or one matvec -- no (D, D, D)
    # tensor even at D = 4096.

    def metric(self, x: Array) -> Array:
        """G(x) = Sigma^{-1} + diag(m e^x).  (..., D) -> (..., D, D).

        NOTE: materializes a dense (D, D) per chain; at D = 4096 use few
        chains (the reference runs one, ``LGC_mMALA_LV.m``)."""
        diag = self.m * jnp.exp(x)
        eye = jnp.eye(self.dim, dtype=x.dtype)
        return self.sigma_inv + diag[..., None] * eye

    def dg_cache(self, x: Array) -> Array:
        """(..., D) diagonal weights m e^x;  dG_d = m e^{x_d} E_dd."""
        return self.m * jnp.exp(x)

    def dg_bilinear(self, x: Array, u: Array, v: Array, *, cache: Array | None = None) -> Array:
        c = self.dg_cache(x) if cache is None else cache
        return c * u * v

    def dg_trace(self, x: Array, mmat: Array, *, cache: Array | None = None) -> Array:
        c = self.dg_cache(x) if cache is None else cache
        return c * jnp.diagonal(mmat, axis1=-2, axis2=-1)

    def dg_dotted(self, x: Array, mmat: Array, *, cache: Array | None = None) -> Array:
        """[sum_e (M dG_e M)[:, e]] = M @ (c * diag M)."""
        c = self.dg_cache(x) if cache is None else cache
        weights = c * jnp.diagonal(mmat, axis1=-2, axis2=-1)
        return jnp.einsum("...ie,...e->...i", mmat, weights, precision=_PREC)

    def manifold_state(self, x: Array):
        from riemannhamiltonianmontecarlo.models.logreg import ManifoldState

        logp, grad = self.logp_and_grad(x)
        return ManifoldState(logp, grad, self.metric(x), self.dg_cache(x))

    # -- whitened view (MALA w/ transformation, ``LGC_MALA_Transient.m``) ---

    def whitened(self):
        """Model over gamma with x = mu + L gamma, L = chol(Sigma).

        The reference's "MALA with transformation" samples in this
        whitened parametrization (``LGC_MALA_Transient.m:32-37``); the
        Jacobian is constant so log densities differ by a constant.
        """
        sigma_np = grid_covariance(self.n, self.s, self.b)
        chol = jnp.asarray(
            np.linalg.cholesky(sigma_np + 1e-10 * np.eye(self.dim)), jnp.float32
        )
        model = self

        class _Whitened:
            dim = model.dim

            def to_x(self, gamma):
                return model.mu + jnp.matmul(gamma, chol.T, precision=_PREC)

            def logp(self, gamma):
                return model.logp(self.to_x(gamma))

            def grad(self, gamma):
                gx = model.grad(self.to_x(gamma))
                return jnp.matmul(gx, chol, precision=_PREC)

            def logp_and_grad(self, gamma):
                lp, gx = model.logp_and_grad(self.to_x(gamma))
                return lp, jnp.matmul(gx, chol, precision=_PREC)

        return _Whitened()


@dataclasses.dataclass(frozen=True)
class LGCJointModel:
    """LGC with *unknown* GP hyperparameters (sigma^2, beta).

    Reference ``LGC_RMHMC_Paras_LV.m`` -- the most expensive config in the
    repo (paper sec. 8: ~90 CPU-hours for 5000 samples).  Inference
    alternates RMHMC on theta = (sigma^2, beta) with constant-metric
    latent-field updates, where each theta move rebuilds the dense GP
    algebra:

    * target over theta~ = (log sigma^2, log beta) given x
      (``:147-150,343-349``): -1/2 log|Sigma| - 1/2 (x-mu)^T Sigma^{-1}
      (x-mu) + Gamma(2, 0.5) log-priors + the log-coordinate Jacobian;
    * expected-Fisher metric G_ij = 1/2 tr(A_i A_j) + prior curvature,
      A_i = Sigma^{-1} dSigma/dtheta~_i with dSigma/dlog sigma^2 = Sigma
      and dSigma/dlog beta = (dist/(beta n)) o Sigma (``:101-121``);
    * dG by jacfwd of the metric (the reference hand-codes the same
      third-order products, ``:127-139``).  mu is FIXED at
      log(126) - 1.91/2 (``:28``).

    All per-theta quantities are dense (D, D) = (n^2, n^2) matmuls and
    factorizations; batch over a handful of chains only.

    Deviation (documented): the MATLAB gradient omits the Jacobian's
    derivative (+1 per coordinate) that its own Hamiltonian includes --
    we use the self-consistent gradient (exact autodiff class of fix,
    same as StochVol/FHN).
    """

    y: Array
    n: int = 64
    gamma_k: float = 2.0  # LGC_RMHMC_Paras_LV.m:32
    gamma_theta: float = 0.5  # :33
    init_sigma_sq: float = 1.91  # :26 -- also pins mu
    init_beta: float = 1.0 / 33.0  # :27

    def __post_init__(self):
        object.__setattr__(self, "y", jnp.asarray(self.y, jnp.float32))
        object.__setattr__(self, "mu", float(np.log(126.0) - self.init_sigma_sq / 2.0))
        object.__setattr__(self, "m", 1.0 / self.n**2)
        object.__setattr__(
            self, "dist", jnp.asarray(grid_distances(self.n), jnp.float32)
        )

    @property
    def dim(self) -> int:
        return self.n * self.n

    def sigma_of(self, theta_t: Array) -> Array:
        """Sigma(theta~) for a single (2,) theta~ -> (D, D)."""
        sigma_sq = jnp.exp(theta_t[0])
        beta = jnp.exp(theta_t[1])
        return sigma_sq * jnp.exp(-self.dist / (beta * self.n))

    # -- single-chain hyper-block quantities --------------------------------

    def _hyper_logp_single(self, theta_t: Array, x: Array) -> Array:
        sigma = self.sigma_of(theta_t)
        chol = jnp.linalg.cholesky(sigma)
        centered = x - self.mu
        v = jax.scipy.linalg.cho_solve((chol, True), centered)
        half_logdet = jnp.sum(jnp.log(jnp.diagonal(chol)))
        quad = jnp.dot(centered, v, precision=_PREC)
        # Gamma(k, theta) priors on sigma^2 and beta plus the log-coord
        # Jacobian: (k-1) t_i - exp(t_i)/gamma_theta + t_i.
        t = theta_t
        prior = jnp.sum(self.gamma_k * t - jnp.exp(t) / self.gamma_theta)
        return -half_logdet - 0.5 * quad + prior

    def _hyper_metric_single(self, theta_t: Array) -> Array:
        sigma = self.sigma_of(theta_t)
        beta = jnp.exp(theta_t[1])
        chol = jnp.linalg.cholesky(sigma)
        scale = self.dist / (beta * self.n)
        d_sigma1 = sigma  # dSigma/dlog sigma^2
        d_sigma2 = scale * sigma  # dSigma/dlog beta
        a1 = jax.scipy.linalg.cho_solve((chol, True), d_sigma1)
        a2 = jax.scipy.linalg.cho_solve((chol, True), d_sigma2)
        g11 = 0.5 * jnp.sum(a1 * a1.T)
        g12 = 0.5 * jnp.sum(a1 * a2.T)
        g22 = 0.5 * jnp.sum(a2 * a2.T)
        # Prior curvature (LGC_RMHMC_Paras_LV.m:120-121).
        g11 = g11 + jnp.exp(theta_t[0]) / self.gamma_theta
        g22 = g22 + beta / self.gamma_theta
        return jnp.stack(
            [jnp.stack([g11, g12]), jnp.stack([g12, g22])]
        )

    # -- fused closed-form hyper geometry -----------------------------------
    #
    # Sigma(theta~) = sigma^2 K(beta) with K = exp(-S), S = dist/(beta n),
    # so A_1 = Sigma^{-1} dSigma/dt_1 = I exactly and every Fisher/dG term
    # reduces to ONE Cholesky of K, cho_solves for A_2 = K^{-1}(S o K) and
    # B = K^{-1}((S^2 - S) o K), and one matmul A_2 A_2 -- instead of
    # jacfwd through Cholesky factorizations (the round-2 implementation,
    # ~5x the flops and a multi-minute XLA compile at D = 4096).  Identities
    # (d/dt_2 means d/d log beta):
    #
    #   d(S o K)/dt_2 = (S^2 - S) o K          (dS/dt_2 = -S, dK/dt_2 = S o K)
    #   dA_2/dt_2     = -A_2 A_2 + B
    #   G = [[D/2, tr(A_2)/2], [., tr(A_2 A_2)/2]] + diag prior curvature
    #   dG/dt_2[1,1]  = -tr(A_2^3) + tr(A_2 B) + beta/gamma_theta
    #
    # with tr(A_2 A_2) = sum(A_2 o A_2^T), tr(A_2^3) = sum((A_2 A_2) o A_2^T),
    # tr(A_2 B) = sum(A_2 o B^T) -- elementwise, no extra matmuls.  Verified
    # against the autodiff oracle (``use_autodiff=True``) in tests/test_lgc.py.

    def _hyper_geom_single(self, theta_t: Array, x: Array, *, parts: str):
        """Fused hyper-block geometry at one (2,) theta~.

        parts: "logp" (logp only), "metric" (metric only), or "full"
        (logp, grad, metric, dG) -- the three call shapes of the RMHMC /
        mMALA kernels, each paying only the linear algebra it needs.
        """
        d = self.dim
        t1, t2 = theta_t[0], theta_t[1]
        sigma_sq, beta = jnp.exp(t1), jnp.exp(t2)
        s_mat = self.dist / (beta * self.n)
        k_mat = jnp.exp(-s_mat)
        chol_k = jnp.linalg.cholesky(k_mat)
        out = {}

        if parts in ("logp", "full"):
            c = x - self.mu
            v = jax.scipy.linalg.cho_solve((chol_k, True), c)  # K^{-1} c
            quad = jnp.dot(c, v, precision=_PREC) / sigma_sq  # c^T Sigma^{-1} c
            half_logdet = 0.5 * d * t1 + jnp.sum(jnp.log(jnp.diagonal(chol_k)))
            prior = jnp.sum(self.gamma_k * theta_t - jnp.exp(theta_t) / self.gamma_theta)
            out["logp"] = -half_logdet - 0.5 * quad + prior

        if parts == "logp":
            return out

        sk = s_mat * k_mat
        a2 = jax.scipy.linalg.cho_solve((chol_k, True), sk)  # K^{-1}(S o K)
        tr_a2 = jnp.trace(a2)
        tr_a2_sq = jnp.sum(a2 * a2.T)
        out["metric"] = jnp.stack([
            jnp.stack([0.5 * d + sigma_sq / self.gamma_theta, 0.5 * tr_a2]),
            jnp.stack([0.5 * tr_a2, 0.5 * tr_a2_sq + beta / self.gamma_theta]),
        ])
        if parts == "metric":
            return out

        # gradient: dlogp/dt_i = -1/2 tr(A_i) + 1/2 c^T Sigma^{-1} dSigma_i
        # Sigma^{-1} c + prior' (LGC_RMHMC_Paras_LV.m target, :147-150).
        g1 = -0.5 * d + 0.5 * quad + self.gamma_k - sigma_sq / self.gamma_theta
        skv = jnp.matmul(sk, v, precision=_PREC)
        g2 = (-0.5 * tr_a2 + 0.5 * jnp.dot(v, skv, precision=_PREC) / sigma_sq
              + self.gamma_k - beta / self.gamma_theta)
        out["grad"] = jnp.stack([g1, g2])

        b_mat = jax.scipy.linalg.cho_solve((chol_k, True), (s_mat * s_mat - s_mat) * k_mat)
        a2a2 = jnp.matmul(a2, a2, precision=_PREC)
        tr_a2_cube = jnp.sum(a2a2 * a2.T)
        tr_a2_b = jnp.sum(a2 * b_mat.T)
        dg12 = 0.5 * (jnp.trace(b_mat) - tr_a2_sq)
        dg22 = -tr_a2_cube + tr_a2_b + beta / self.gamma_theta
        zero = jnp.zeros_like(dg12)
        dg = jnp.stack([
            jnp.stack([jnp.stack([sigma_sq / self.gamma_theta, zero]),
                       jnp.stack([zero, zero])]),
            jnp.stack([jnp.stack([zero, dg12]),
                       jnp.stack([dg12, dg22])]),
        ])  # (2, 2, 2): dg[i] = dG/dt_i
        out["dg"] = dg
        return out

    def hyper_manifold(self, x: Array, *, use_autodiff: bool = False):
        """ManifoldModel view of theta~ | x (batched over leading axes).

        ``use_autodiff=True`` derives grad/dG by jacfwd through the
        reference-shaped ``_hyper_logp_single`` / ``_hyper_metric_single``
        -- the slow oracle the closed-form path is tested against.
        """
        from riemannhamiltonianmontecarlo.models.logreg import ManifoldState

        model = self

        def _batched(fn, th, *args):
            if th.ndim == 1:
                return fn(th, *args)
            lead = th.shape[:-1]
            flat = [a.reshape((-1,) + a.shape[len(lead):]) for a in (th, *args)]
            out = jax.vmap(fn)(*flat)
            return jax.tree.map(lambda o: o.reshape(lead + o.shape[1:]), out)

        if use_autodiff:
            return self._hyper_manifold_autodiff(x, _batched)

        def _geom(th, parts: str):
            if x.ndim == 1:
                return _batched(lambda a: model._hyper_geom_single(a, x, parts=parts), th)
            return _batched(lambda a, xx: model._hyper_geom_single(a, xx, parts=parts),
                            th, x)

        class _HyperManifold:
            dim = 2

            @staticmethod
            def logp(th):
                return _geom(th, "logp")["logp"]

            @staticmethod
            def grad(th):
                return _geom(th, "full")["grad"]

            @staticmethod
            def logp_and_grad(th):
                g = _geom(th, "full")
                return g["logp"], g["grad"]

            @staticmethod
            def metric(th):
                return _geom(th, "metric")["metric"]

            @staticmethod
            def dg_cache(th):
                return _geom(th, "full")["dg"]

            @staticmethod
            def _dg(th, cache):
                return _HyperManifold.dg_cache(th) if cache is None else cache

            @staticmethod
            def dg_bilinear(th, u, v, *, cache=None):
                return jnp.einsum("...dab,...a,...b->...d",
                                  _HyperManifold._dg(th, cache), u, v, precision=_PREC)

            @staticmethod
            def dg_trace(th, m, *, cache=None):
                return jnp.einsum("...dab,...ba->...d",
                                  _HyperManifold._dg(th, cache), m, precision=_PREC)

            @staticmethod
            def dg_dotted(th, m, *, cache=None):
                return jnp.einsum("...ia,...eab,...be->...i", m,
                                  _HyperManifold._dg(th, cache), m, precision=_PREC)

            @staticmethod
            def manifold_state(th):
                g = _geom(th, "full")
                return ManifoldState(g["logp"], g["grad"], g["metric"], g["dg"])

        return _HyperManifold()

    def _hyper_manifold_autodiff(self, x: Array, _batched):
        """jacfwd-based oracle (the round-2 implementation)."""
        from riemannhamiltonianmontecarlo.models.base import autodiff_manifold
        from riemannhamiltonianmontecarlo.models.logreg import ManifoldState

        model = self

        class _Hyper:
            dim = 2

            def logp(self, th):
                if x.ndim == 1:
                    return _batched(lambda a: model._hyper_logp_single(a, x), th)
                return _batched(model._hyper_logp_single, th, x)

            def grad(self, th):
                g = jax.grad(model._hyper_logp_single)
                if x.ndim == 1:
                    return _batched(lambda a: g(a, x), th)
                return _batched(g, th, x)

            def logp_and_grad(self, th):
                return self.logp(th), self.grad(th)

        base = _Hyper()
        mani = autodiff_manifold(base, model._hyper_metric_single)

        class _HyperManifold:
            dim = 2
            logp = staticmethod(base.logp)
            grad = staticmethod(base.grad)
            logp_and_grad = staticmethod(base.logp_and_grad)
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

    # -- latent block given theta -------------------------------------------

    def latent_logp_and_grad(self, x: Array, sigma_inv: Array) -> tuple[Array, Array]:
        """Poisson-count conditional given the current Sigma^{-1} (per chain)."""
        centered = x - self.mu
        sx = jnp.einsum("...ab,...b->...a", sigma_inv, centered, precision=_PREC)
        expx = jnp.exp(x)
        logp = (
            jnp.sum(x * self.y, axis=-1)
            - self.m * jnp.sum(expx, axis=-1)
            - 0.5 * jnp.sum(centered * sx, axis=-1)
        )
        return logp, self.y - self.m * expx - sx

    def latent_mass(self, theta_t: Array) -> tuple[Array, Array, Array]:
        """(Sigma^{-1}, chol G, G^{-1}) at theta~ for one chain.

        G = Sigma^{-1} + diag(m exp(mu + diag Sigma)) -- the constant-
        metric trick re-evaluated at the current hyperparameters
        (``LGC_RMHMC_Paras_LV.m`` latent block).
        """
        sigma = self.sigma_of(theta_t)
        chol_s = jnp.linalg.cholesky(sigma)
        eye = jnp.eye(self.dim, dtype=sigma.dtype)
        sigma_inv = jax.scipy.linalg.cho_solve((chol_s, True), eye)
        g = sigma_inv + jnp.diag(self.m * jnp.exp(self.mu + jnp.diagonal(sigma)))
        chol_g = jnp.linalg.cholesky(g)
        g_inv = jax.scipy.linalg.cho_solve((chol_g, True), eye)
        return sigma_inv, chol_g, g_inv

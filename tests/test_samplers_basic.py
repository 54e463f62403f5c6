"""Statistical correctness of HMC and adaptive Metropolis on known targets.

Pattern from SURVEY.md section 4: known-truth targets (an exact Gaussian)
plus posterior-moment checks on synthetic logistic data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riemannhamiltonianmontecarlo.models import LogisticRegression, synthetic_logreg
from riemannhamiltonianmontecarlo.models.base import FunctionModel
from riemannhamiltonianmontecarlo.parallel import run
from riemannhamiltonianmontecarlo.samplers import hmc, metropolis


class GaussianTarget:
    """Correlated 3-D Gaussian with known moments (batched logp/grad)."""

    def __init__(self):
        a = np.array([[2.0, 0.5, 0.0], [0.5, 1.5, 0.3], [0.0, 0.3, 1.0]])
        self.cov = a @ a.T
        self.prec = jnp.asarray(np.linalg.inv(self.cov), dtype=jnp.float32)
        self.mean = jnp.asarray([1.0, -0.5, 2.0])
        self.dim = 3

    def logp(self, w):
        d = w - self.mean
        return -0.5 * jnp.einsum("...a,ab,...b->...", d, self.prec, d)

    def grad(self, w):
        return -jnp.einsum("ab,...b->...a", self.prec, w - self.mean)

    def logp_and_grad(self, w):
        return self.logp(w), self.grad(w)


@pytest.fixture(scope="module")
def gaussian():
    return GaussianTarget()


def _moments(samples):
    flat = np.asarray(samples).reshape(-1, samples.shape[-1])
    return flat.mean(axis=0), np.cov(flat.T)


def test_hmc_gaussian_moments(gaussian):
    kernel = hmc.build(gaussian, hmc.HMCConfig(step_size=0.25, num_leapfrog=12))
    init = jnp.zeros((64, 3))
    res = run(kernel, jax.random.key(0), init, num_samples=600, burn_in=200)
    mean, cov = _moments(res.samples)
    assert float(res.accept_rate) > 0.6
    np.testing.assert_allclose(mean, np.asarray(gaussian.mean), atol=0.15)
    np.testing.assert_allclose(cov, gaussian.cov, atol=0.6)


def test_hmc_fixed_length_runs(gaussian):
    kernel = hmc.build(
        gaussian, hmc.HMCConfig(step_size=0.2, num_leapfrog=8, randomize_length=False)
    )
    init = jnp.zeros((8, 3))
    res = run(kernel, jax.random.key(1), init, num_samples=50, burn_in=10)
    assert res.samples.shape == (8, 50, 3)
    assert np.isfinite(np.asarray(res.samples)).all()


def test_amh_gaussian_moments(gaussian):
    kernel = metropolis.build(
        gaussian, metropolis.AMHConfig(init_proposal_sd=1.0, adapt_interval=50, adapt_until=300)
    )
    init = jnp.zeros((64, 3))
    res = run(kernel, jax.random.key(2), init, num_samples=1500, burn_in=400)
    mean, cov = _moments(res.samples)
    np.testing.assert_allclose(mean, np.asarray(gaussian.mean), atol=0.2)
    np.testing.assert_allclose(np.diag(cov), np.diag(gaussian.cov), rtol=0.35)


def test_amh_adapts_proposal_sd(gaussian):
    kernel = metropolis.build(
        gaussian, metropolis.AMHConfig(init_proposal_sd=25.0, adapt_interval=20, adapt_until=10_000)
    )
    init = jnp.zeros((16, 3))
    res = run(kernel, jax.random.key(3), init, num_samples=300, burn_in=0)
    sd = np.asarray(res.final_state.proposal_sd)
    assert np.all(sd < 25.0)  # huge initial SD must have been shrunk


def test_hmc_blr_posterior_mode(gaussian):
    """Posterior mean of synthetic BLR concentrates near the MAP estimate."""
    ds = synthetic_logreg(seed=5, n=200, d=4, w_scale=1.0)
    model = LogisticRegression(jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32))

    # MAP by plain gradient ascent (small problem, exact enough).
    w = jnp.zeros(model.dim)
    for _ in range(400):
        w = w + 0.01 * model.grad(w)

    kernel = hmc.build(model, hmc.HMCConfig(step_size=0.1, num_leapfrog=20))
    init = jnp.zeros((32, model.dim))
    res = run(kernel, jax.random.key(4), init, num_samples=500, burn_in=200)
    mean, _ = _moments(res.samples)
    assert float(res.accept_rate) > 0.6
    np.testing.assert_allclose(mean, np.asarray(w), atol=0.25)


def test_divergence_masking(gaussian):
    """A catastrophically large step size must reject, not NaN the batch."""
    kernel = hmc.build(gaussian, hmc.HMCConfig(step_size=50.0, num_leapfrog=10))
    init = jnp.ones((8, 3))
    res = run(kernel, jax.random.key(6), init, num_samples=20, burn_in=0)
    assert np.isfinite(np.asarray(res.samples)).all()
    assert float(res.accept_rate) < 0.1

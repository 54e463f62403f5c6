"""RMHMC / mMALA / MALA / IWLS statistical correctness.

Oracles (SURVEY.md section 4 test strategy):
* constant-metric Gaussian -- generalized leapfrog must collapse to
  preconditioned HMC and reproduce exact moments;
* synthetic BLR -- cross-sampler posterior parity (every kernel targets
  the same posterior, so their moments must agree within MC error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riemannhamiltonianmontecarlo.models import LogisticRegression, synthetic_logreg
from riemannhamiltonianmontecarlo.parallel import run
from riemannhamiltonianmontecarlo.samplers import hmc, iwls, mala, mmala, rmhmc

from targets import ConstantMetricGaussian


@pytest.fixture(scope="module")
def gaussian():
    a = np.array([[2.0, 0.7], [0.7, 1.0]])
    return ConstantMetricGaussian(mean=[1.5, -1.0], cov=a @ a.T)


@pytest.fixture(scope="module")
def blr():
    ds = synthetic_logreg(seed=11, n=150, d=4, w_scale=1.0)
    return LogisticRegression(jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32))


@pytest.fixture(scope="module")
def blr_hmc_moments(blr):
    kernel = hmc.build(blr, hmc.HMCConfig(step_size=0.12, num_leapfrog=25))
    init = jnp.zeros((48, blr.dim))
    res = run(kernel, jax.random.key(100), init, num_samples=800, burn_in=300)
    flat = np.asarray(res.samples).reshape(-1, blr.dim)
    return flat.mean(axis=0), flat.std(axis=0)


def _moments(samples):
    flat = np.asarray(samples).reshape(-1, samples.shape[-1])
    return flat.mean(axis=0), np.cov(flat.T)


def test_rmhmc_constant_metric_gaussian(gaussian):
    kernel = rmhmc.build(
        gaussian, rmhmc.RMHMCConfig(step_size=0.5, num_leapfrog=6, num_fixed_point=4)
    )
    init = jnp.zeros((64, 2))
    res = run(kernel, jax.random.key(0), init, num_samples=700, burn_in=200)
    mean, cov = _moments(res.samples)
    assert float(res.accept_rate) > 0.85  # near-exact integration on a Gaussian
    np.testing.assert_allclose(mean, np.asarray(gaussian.mean), atol=0.15)
    np.testing.assert_allclose(cov, gaussian.cov, atol=0.6)


def test_mmala_constant_metric_gaussian(gaussian):
    kernel = mmala.build(gaussian, mmala.MMALAConfig(step_size=1.0))
    init = jnp.zeros((64, 2))
    res = run(kernel, jax.random.key(1), init, num_samples=1200, burn_in=300)
    mean, cov = _moments(res.samples)
    assert float(res.accept_rate) > 0.5
    np.testing.assert_allclose(mean, np.asarray(gaussian.mean), atol=0.2)
    np.testing.assert_allclose(cov, gaussian.cov, atol=0.7)


def test_mala_gaussian(gaussian):
    kernel = mala.build(gaussian, mala.MALAConfig(step_size=1.0))
    warm = mala.build(gaussian, mala.MALAConfig(step_size=1.0, transient=True))
    init = jnp.zeros((64, 2))
    res = run(
        kernel, jax.random.key(2), init, num_samples=2500, burn_in=500, warmup_kernel=warm
    )
    mean, cov = _moments(res.samples)
    np.testing.assert_allclose(mean, np.asarray(gaussian.mean), atol=0.25)
    np.testing.assert_allclose(np.diag(cov), np.diag(gaussian.cov), rtol=0.4)


def test_rmhmc_blr_matches_hmc(blr, blr_hmc_moments):
    hmc_mean, hmc_std = blr_hmc_moments
    kernel = rmhmc.build(blr, rmhmc.RMHMCConfig())  # reference defaults eps=.5 L=6 K=4
    init = jnp.full((48, blr.dim), 1e-3)  # reference init, code/rmhmc.py:27
    res = run(kernel, jax.random.key(3), init, num_samples=700, burn_in=200)
    mean, cov = _moments(res.samples)
    assert 0.5 < float(res.accept_rate) <= 1.0
    assert int(res.divergences) == 0
    np.testing.assert_allclose(mean, hmc_mean, atol=4 * np.max(hmc_std) / np.sqrt(48))
    np.testing.assert_allclose(np.sqrt(np.diag(cov)), hmc_std, rtol=0.3)


def test_mmala_blr_matches_hmc(blr, blr_hmc_moments):
    hmc_mean, hmc_std = blr_hmc_moments
    kernel = mmala.build(blr, mmala.MMALAConfig(step_size=1.0))
    init = jnp.zeros((48, blr.dim))
    res = run(kernel, jax.random.key(4), init, num_samples=1500, burn_in=400)
    mean, _ = _moments(res.samples)
    assert float(res.accept_rate) > 0.4
    np.testing.assert_allclose(mean, hmc_mean, atol=6 * np.max(hmc_std) / np.sqrt(48))


def test_simplified_mmala_blr(blr, blr_hmc_moments):
    hmc_mean, hmc_std = blr_hmc_moments
    kernel = mmala.build(blr, mmala.MMALAConfig(step_size=1.0, simplified=True))
    init = jnp.zeros((48, blr.dim))
    res = run(kernel, jax.random.key(5), init, num_samples=1500, burn_in=400)
    mean, _ = _moments(res.samples)
    assert float(res.accept_rate) > 0.4
    np.testing.assert_allclose(mean, hmc_mean, atol=6 * np.max(hmc_std) / np.sqrt(48))


def test_iwls_blr_matches_hmc(blr, blr_hmc_moments):
    hmc_mean, hmc_std = blr_hmc_moments
    kernel = iwls.build(blr)
    init = jnp.zeros((48, blr.dim))
    res = run(kernel, jax.random.key(6), init, num_samples=1200, burn_in=300)
    mean, _ = _moments(res.samples)
    assert float(res.accept_rate) > 0.2
    np.testing.assert_allclose(mean, hmc_mean, atol=6 * np.max(hmc_std) / np.sqrt(48))


def test_rmhmc_no_random_direction_reversibility(gaussian):
    """Forward-only trajectories must still sample the target correctly."""
    kernel = rmhmc.build(
        gaussian,
        rmhmc.RMHMCConfig(step_size=0.4, num_leapfrog=4, random_direction=False),
    )
    init = jnp.zeros((32, 2))
    res = run(kernel, jax.random.key(7), init, num_samples=600, burn_in=150)
    mean, _ = _moments(res.samples)
    np.testing.assert_allclose(mean, np.asarray(gaussian.mean), atol=0.25)


def test_studentt_rmhmc_blr_matches_hmc(blr, blr_hmc_moments):
    """Heavy-tailed momentum leaves the invariant distribution unchanged."""
    hmc_mean, hmc_std = blr_hmc_moments
    kernel = rmhmc.build(blr, rmhmc.RMHMCConfig(student_t=True))
    init = jnp.full((48, blr.dim), 1e-3)
    res = run(kernel, jax.random.key(8), init, num_samples=900, burn_in=300)
    mean, _ = _moments(res.samples)
    assert float(res.accept_rate) > 0.3
    np.testing.assert_allclose(mean, hmc_mean, atol=6 * np.max(hmc_std) / np.sqrt(48))


def test_pmala_exact_moments_gaussian(gaussian):
    """Constant-metric mMALA (samplers/pmala.py, LGC_mMALA_LV.m contract)
    must reproduce the exact moments of a Gaussian target when
    preconditioned by its own precision."""
    from riemannhamiltonianmontecarlo.samplers import pmala

    prec64 = np.linalg.inv(gaussian.cov)
    mass_chol = jnp.asarray(np.linalg.cholesky(prec64), jnp.float32)
    kernel = pmala.build(gaussian, mass_chol, jnp.asarray(gaussian.cov, jnp.float32),
                         pmala.PMALAConfig(step_size=1.0))
    c = 256
    init = jnp.zeros((c, gaussian.dim))
    res = run(kernel, jax.random.key(9), init, num_samples=1500, burn_in=500)
    assert 0.4 < float(res.accept_rate) < 0.99
    s = np.asarray(res.samples, np.float64).reshape(-1, gaussian.dim)
    np.testing.assert_allclose(s.mean(0), np.asarray(gaussian.mean), atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), gaussian.cov, atol=0.12)

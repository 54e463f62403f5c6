"""Dual-averaging step-size adaptation."""

import jax
import jax.numpy as jnp
import numpy as np

from riemannhamiltonianmontecarlo.parallel import run_adaptive
from riemannhamiltonianmontecarlo.parallel.adaptation import AdaptationConfig
from riemannhamiltonianmontecarlo.samplers import hmc, mala, rmhmc

from targets import ConstantMetricGaussian


def _gaussian():
    a = np.array([[2.0, 0.7], [0.7, 1.0]])
    return ConstantMetricGaussian(mean=[1.5, -1.0], cov=a @ a.T)


def test_hmc_dual_averaging_hits_target():
    target = _gaussian()
    cfg = hmc.HMCConfig(step_size=5.0, num_leapfrog=8)  # far too big on purpose
    res, eps = run_adaptive(
        hmc.build,
        target,
        cfg,
        jax.random.key(0),
        jnp.zeros((128, 2)),
        num_samples=300,
        warmup=200,
        adapt=AdaptationConfig(target_accept=0.8),
    )
    assert eps < 5.0  # shrank from the absurd initial value
    # Frozen-step acceptance should land near the target.
    assert abs(float(res.accept_rate) - 0.8) < 0.12, (eps, float(res.accept_rate))
    flat = np.asarray(res.samples).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(0), np.asarray(target.mean), atol=0.25)


def test_rmhmc_dual_averaging_runs():
    target = _gaussian()
    cfg = rmhmc.RMHMCConfig(step_size=0.05, num_leapfrog=4, num_fixed_point=3)
    res, eps = run_adaptive(
        rmhmc.build,
        target,
        cfg,
        jax.random.key(1),
        jnp.zeros((64, 2)),
        num_samples=200,
        warmup=150,
        adapt=AdaptationConfig(target_accept=0.9),
    )
    assert eps > 0.05  # tiny initial step should have grown
    assert float(res.accept_rate) > 0.6


def test_mala_dual_averaging_direction():
    target = _gaussian()
    cfg = mala.MALAConfig(step_size=50.0)
    res, eps = run_adaptive(
        mala.build,
        target,
        cfg,
        jax.random.key(2),
        jnp.zeros((128, 2)),
        num_samples=200,
        warmup=300,
        adapt=AdaptationConfig(target_accept=0.574),
    )
    assert eps < 50.0
    assert abs(float(res.accept_rate) - 0.574) < 0.15

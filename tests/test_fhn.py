"""FitzHugh-Nagumo ODE model: integrator, autodiff geometry, RMHMC.

Small settings (50 obs, 3 substeps, short chains) for CPU speed; the
known-truth pattern from the reference run scripts (RunFHN_RMHMC.m:41:
data generated at (0.2, 0.2, 3)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riemannhamiltonianmontecarlo.models import fhn
from riemannhamiltonianmontecarlo.parallel import run
from riemannhamiltonianmontecarlo.samplers import rmhmc

THETA_TRUE = np.array([0.2, 0.2, 3.0])


@pytest.fixture(scope="module")
def model():
    data, _ = fhn.generate_data(seed=2, num_obs=50)
    return fhn.FHNModel(jnp.asarray(data, jnp.float32), substeps=3)


def test_integrator_against_scipy():
    from scipy.integrate import solve_ivp

    theta = THETA_TRUE

    def rhs(t, y):
        v, r = y
        a, b, c = theta
        return [c * (v - v**3 / 3 + r), -(v - a + b * r) / c]

    ts = np.linspace(0, 20, 200)
    ref = solve_ivp(rhs, (0, 20), [-1, 1], t_eval=ts, rtol=1e-8, atol=1e-8).y.T
    ours = np.asarray(fhn.integrate_rk4(jnp.asarray(theta), num_obs=200, substeps=10))
    np.testing.assert_allclose(ours, ref, atol=5e-3)


def test_grad_matches_finite_differences(model):
    theta = jnp.asarray([0.3, 0.25, 2.5], jnp.float32)
    g = np.asarray(model.grad(theta))
    for i in range(3):
        e = np.zeros(3, np.float32)
        e[i] = 1e-3
        fd = (float(model.logp(theta + e)) - float(model.logp(theta - e))) / 2e-3
        np.testing.assert_allclose(g[i], fd, rtol=2e-2, atol=0.5)


def test_logp_rejects_invalid_support(model):
    assert float(model.logp(jnp.asarray([-0.1, 0.2, 3.0]))) == -np.inf
    g = np.asarray(model.grad(jnp.asarray([-0.1, 0.2, 3.0])))
    assert np.isfinite(g).all()  # masked, not NaN


def test_metric_pd_near_truth(model):
    theta = jnp.asarray(THETA_TRUE, jnp.float32)
    g = np.asarray(model.metric(theta), np.float64)
    assert np.linalg.eigvalsh(g).min() > 0
    # Batched call agrees with single
    gb = np.asarray(model.metric(jnp.stack([theta, theta])))
    np.testing.assert_allclose(gb[0], g, rtol=1e-5)


def test_rmhmc_posterior_near_truth(model):
    kernel = rmhmc.build(
        model,
        rmhmc.RMHMCConfig(step_size=0.25, num_leapfrog=3, num_fixed_point=3, jitter=1e-6),
    )
    c = 8
    key = jax.random.key(0)
    init = jnp.asarray(THETA_TRUE, jnp.float32) * jnp.exp(
        0.1 * jax.random.normal(key, (c, 3))
    )
    res = run(kernel, jax.random.key(1), init, num_samples=150, burn_in=100)
    assert float(res.accept_rate) > 0.3
    mean = np.asarray(res.samples).reshape(-1, 3).mean(0)
    err = np.abs(mean - THETA_TRUE)
    assert np.all(err < np.array([0.15, 0.3, 0.3])), (mean, err)


def test_fhn_mmala_posterior_near_truth(model):
    """Posterior correctness (not smoke) for mMALA, the paper's FHN winner
    (Table 11, ODE_mMALA.m:69: eps = 1)."""
    from riemannhamiltonianmontecarlo.samplers import mmala

    kernel = mmala.build(model, mmala.MMALAConfig(step_size=1.0, jitter=1e-6))
    c = 8
    init = jnp.asarray(THETA_TRUE, jnp.float32) * jnp.exp(
        0.1 * jax.random.normal(jax.random.key(4), (c, 3))
    )
    res = run(kernel, jax.random.key(5), init, num_samples=250, burn_in=150)
    assert float(res.accept_rate) > 0.3
    mean = np.asarray(res.samples).reshape(-1, 3).mean(0)
    err = np.abs(mean - THETA_TRUE)
    assert np.all(err < np.array([0.15, 0.3, 0.3])), (mean, err)


def test_fhn_comparator_kernels_smoke(model):
    """mMALA / MALA / Metropolis run on the ODE model via generic kernels
    (reference ODE_mMALA.m / ODE_MALA.m / ODE_Metropolis.m comparators)."""
    from riemannhamiltonianmontecarlo.samplers import mala, metropolis, mmala

    init = jnp.tile(jnp.asarray(THETA_TRUE, jnp.float32), (4, 1))
    for kernel in (
        mmala.build(model, mmala.MMALAConfig(step_size=1.0, jitter=1e-6)),  # ODE_mMALA.m:69
        mala.build(model, mala.MALAConfig(step_size=2e-4)),  # ODE_MALA.m:64
        metropolis.build(model, metropolis.AMHConfig(init_proposal_sd=0.05)),
    ):
        res = run(kernel, jax.random.key(9), init, num_samples=15, burn_in=5)
        assert np.isfinite(np.asarray(res.samples)).all()

"""Holmes-Held Gibbs sampler + mixing-weight / truncated-normal ops.

The lambda full conditional is *not* a plain GIG: the GIG draw is only
the rejection proposal, and the Kolmogorov-Smirnov squeeze series
corrects it to the exact logistic mixing-weight conditional
(Holmes & Held 2006, appendix; ``code/gibbs_sampler.py:50-70``).
Oracles used here:

* distributional parity against the reference scalar sampler
  (``mixing_weights_sampling``), via a two-sample KS test;
* the stationarity identity: if eps ~ Logistic(0, 1) and
  lambda ~ p(lambda | eps), then eps' ~ N(0, lambda) is again
  Logistic(0, 1) -- the representation the whole sampler rests on.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REF_GIBBS = Path("/root/reference/code/gibbs_sampler.py")

from riemannhamiltonianmontecarlo.models import LogisticRegression, synthetic_logreg
from riemannhamiltonianmontecarlo.ops.gig import sample_gig_half
from riemannhamiltonianmontecarlo.ops.truncnorm import truncated_normal_onesided
from riemannhamiltonianmontecarlo.parallel import run
from riemannhamiltonianmontecarlo.samplers import gibbs, hmc


def test_truncnorm_signs_and_moments():
    key = jax.random.key(0)
    n = 200_000
    mean = jnp.full((n,), 0.5)
    std = jnp.full((n,), 2.0)
    pos = truncated_normal_onesided(key, mean, std, jnp.ones((n,), bool))
    neg = truncated_normal_onesided(key, mean, std, jnp.zeros((n,), bool))
    assert float(jnp.min(pos)) >= 0.0
    assert float(jnp.max(neg)) <= 0.0
    # E[TN_+(m, s)] = m + s * phi(a) / (1 - Phi(a)), a = -m/s
    from scipy.stats import norm

    a = -0.5 / 2.0
    expected = 0.5 + 2.0 * norm.pdf(a) / (1 - norm.cdf(a))
    np.testing.assert_allclose(float(jnp.mean(pos)), expected, rtol=2e-2)


@pytest.mark.skipif(not REF_GIBBS.exists(), reason="reference checkout not available")
def test_mixing_weights_match_reference_oracle():
    """Two-sample KS test vs the reference scalar rejection sampler."""
    spec = importlib.util.spec_from_file_location("ref_gibbs", REF_GIBBS)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    from scipy.stats import ks_2samp

    rng = np.random.default_rng(0)
    for r in [0.3, 1.0, 2.5]:
        np.random.seed(int(10 * r))
        theirs = np.array([ref.mixing_weights_sampling(r * r) for _ in range(4000)])
        ours = np.asarray(sample_gig_half(jax.random.key(int(10 * r)), jnp.full((4000,), r * r)))
        stat, pval = ks_2samp(ours, theirs)
        assert pval > 1e-3, (r, stat, pval, ours.mean(), theirs.mean())


def test_mixing_weights_logistic_stationarity():
    """eps ~ Logistic, lambda ~ p(.|eps), eps' ~ N(0, lambda) => eps' Logistic."""
    from scipy.stats import kstest

    n = 60_000
    key = jax.random.key(11)
    k_eps, k_lam, k_new = jax.random.split(key, 3)
    eps = jax.random.logistic(k_eps, (n,))
    lam = sample_gig_half(k_lam, eps**2)
    eps_new = jnp.sqrt(lam) * jax.random.normal(k_new, (n,))
    stat, pval = kstest(np.asarray(eps_new), "logistic")
    assert pval > 1e-3, (stat, pval)


def test_gig_small_r_stable():
    lam = sample_gig_half(jax.random.key(2), jnp.full((1000,), 1e-10))
    assert np.isfinite(np.asarray(lam)).all()
    assert float(jnp.min(lam)) > 0.0


def test_gibbs_blr_matches_hmc():
    ds = synthetic_logreg(seed=21, n=80, d=3, w_scale=1.0)
    model = LogisticRegression(jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32))

    hmc_kernel = hmc.build(model, hmc.HMCConfig(step_size=0.12, num_leapfrog=25))
    res_h = run(hmc_kernel, jax.random.key(3), jnp.zeros((32, model.dim)),
                num_samples=600, burn_in=200)
    hmc_flat = np.asarray(res_h.samples).reshape(-1, model.dim)
    hmc_mean, hmc_std = hmc_flat.mean(0), hmc_flat.std(0)

    kernel = gibbs.build(model)
    res_g = run(kernel, jax.random.key(4), jnp.zeros((32, model.dim)),
                num_samples=400, burn_in=150)
    assert int(res_g.divergences) == 0
    g_flat = np.asarray(res_g.samples).reshape(-1, model.dim)
    np.testing.assert_allclose(
        g_flat.mean(0), hmc_mean, atol=5 * np.max(hmc_std) / np.sqrt(32)
    )
    # Posterior scale agreement too (auxiliary representation is exact).
    np.testing.assert_allclose(g_flat.std(0), hmc_std, rtol=0.35)

"""Split R-hat: oracle + convergence/divergence behavior + device parity.

The reference has no multi-chain diagnostics (``code/main.py:48-54``
averages serial runs); split-R-hat is the net-new cross-chain convergence
check required by BASELINE.json ("cross-host R-hat").
"""

import jax.numpy as jnp
import numpy as np

from riemannhamiltonianmontecarlo.diagnostics import split_rhat, split_rhat_device


def _chains(rng, c, n, p, rho=0.0, offsets=None):
    x = rng.normal(size=(c, n, p))
    if rho:
        for i in range(1, n):
            x[:, i] = rho * x[:, i - 1] + np.sqrt(1 - rho**2) * x[:, i]
    if offsets is not None:
        x = x + np.asarray(offsets)[:, None, None]
    return x


def test_rhat_converged_iid_near_one():
    rng = np.random.default_rng(0)
    r = split_rhat(_chains(rng, 8, 4000, 3))
    assert r.shape == (3,)
    np.testing.assert_allclose(r, 1.0, atol=0.01)


def test_rhat_detects_between_chain_drift():
    rng = np.random.default_rng(1)
    # Chains stationary within themselves but centered at different values.
    r = split_rhat(_chains(rng, 4, 2000, 2, offsets=[0.0, 1.0, 2.0, 3.0]))
    assert np.all(r > 1.5), r


def test_rhat_detects_within_chain_trend():
    rng = np.random.default_rng(2)
    x = _chains(rng, 4, 2000, 1)
    x += np.linspace(0.0, 4.0, 2000)[None, :, None]  # split halves differ
    r = split_rhat(x)
    # Analytic: W = 1 + trend-var-within-half (2^2/12), between-half means
    # (1, 3) -> var_plus/W = 2.47/1.33 -> R-hat ~ 1.36.
    assert np.all(r > 1.25), r


def test_rhat_oracle_two_chain_closed_form():
    """Hand-computed split-R-hat on a tiny deterministic input."""
    # 2 chains x 4 samples x 1 param -> 4 half-chains of length 2.
    x = np.array([[1.0, 2.0, 3.0, 4.0], [2.0, 2.0, 5.0, 3.0]])[:, :, None]
    halves = np.array([[1, 2], [2, 2], [3, 4], [5, 3]], dtype=np.float64)
    w = halves.var(axis=1, ddof=1).mean()
    b = 2 * halves.mean(axis=1).var(ddof=1)
    expected = np.sqrt(((2 - 1) / 2 * w + b / 2) / w)
    np.testing.assert_allclose(split_rhat(x)[0], expected, rtol=1e-12)


def test_rhat_ar1_matches_theory_direction():
    """AR(1) chains are stationary, so R-hat stays near 1 even though
    autocorrelation is high (R-hat measures mixing across chains, not ESS)."""
    rng = np.random.default_rng(3)
    r = split_rhat(_chains(rng, 8, 8000, 2, rho=0.9))
    np.testing.assert_allclose(r, 1.0, atol=0.05)


def test_rhat_device_matches_host():
    rng = np.random.default_rng(4)
    x = _chains(rng, 4, 1000, 3, rho=0.5, offsets=[0.0, 0.2, -0.1, 0.05])
    host = split_rhat(x)
    dev = np.asarray(split_rhat_device(jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(dev, host, rtol=1e-4)


def test_rhat_odd_length_drops_middle_sample():
    rng = np.random.default_rng(5)
    x = _chains(rng, 4, 1001, 2)
    r_odd = split_rhat(x)
    r_even = split_rhat(x[:, :1000])
    # Same order of magnitude; both near 1. The odd case must not crash.
    np.testing.assert_allclose(r_odd, 1.0, atol=0.02)
    np.testing.assert_allclose(r_even, 1.0, atol=0.02)


def test_parts_matches_host():
    """Segment-parts split-R-hat == dense f64 host R-hat (the parts
    representation is how multi-GB kept-sample trajectories reach the
    RESULTS.md divergent/R-hat columns)."""
    from riemannhamiltonianmontecarlo.diagnostics.rhat import split_rhat_parts

    rng = np.random.default_rng(5)
    x = _chains(rng, 6, 900, 4, offsets=[0.0, 0.5, 1.0, 1.5, 2.0, 2.5])
    cuts = [0, 250, 251, 700, 900]  # uneven parts incl. a 1-sample segment
    parts = [jnp.asarray(x[:, lo:hi], jnp.float32)
             for lo, hi in zip(cuts[:-1], cuts[1:])]
    np.testing.assert_allclose(
        split_rhat_parts(parts), split_rhat(x), rtol=1e-3, atol=1e-4)

"""ESS estimator parity: our vectorized Geyer estimator vs the reference.

The north-star metric is ESS/s *as measured by the reference estimator*
(``code/tools.py:32-74``), so this test imports the reference module
directly as an oracle (skipped when the checkout is absent).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from riemannhamiltonianmontecarlo.diagnostics import (
    autocorrelation,
    ess_geyer,
    ess_multichain,
)

REF_TOOLS = Path("/root/reference/code/tools.py")


def _load_reference_tools():
    spec = importlib.util.spec_from_file_location("ref_tools", REF_TOOLS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ar1_samples(rng, n, p, rho=0.9):
    x = np.zeros((n, p))
    noise = rng.normal(size=(n, p))
    for i in range(1, n):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho**2) * noise[i]
    return x


@pytest.mark.skipif(not REF_TOOLS.exists(), reason="reference checkout not available")
def test_ess_matches_reference_oracle():
    ref = _load_reference_tools()
    rng = np.random.default_rng(0)
    x = ar1_samples(rng, 1200, 4, rho=0.8)
    ours = ess_geyer(x, max_lag=x.shape[0] - 1, nfft_mode="reference")
    theirs = ref.CalculateESS(x, x.shape[0] - 1).reshape(-1)
    np.testing.assert_allclose(ours, theirs, rtol=1e-10)


@pytest.mark.skipif(not REF_TOOLS.exists(), reason="reference checkout not available")
def test_acf_matches_reference_oracle():
    ref = _load_reference_tools()
    rng = np.random.default_rng(1)
    x = ar1_samples(rng, 500, 1, rho=0.5)[:, 0]
    ours = autocorrelation(x, 100, nfft_mode="reference")[:, 0]
    theirs = ref.ac(x, 100)
    np.testing.assert_allclose(ours, theirs, rtol=1e-10)


def test_iid_ess_near_n():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5000, 3))
    ess = ess_geyer(x, nfft_mode="exact")
    assert np.all(ess > 2500), ess  # iid -> ESS approx N (estimator noise allowed)


def test_correlated_ess_much_smaller():
    rng = np.random.default_rng(3)
    x = ar1_samples(rng, 5000, 2, rho=0.95)
    ess = ess_geyer(x, nfft_mode="exact")
    # AR(1) with rho=0.95 -> ESS approx N * (1-rho)/(1+rho) approx 128
    assert np.all(ess < 600), ess
    assert np.all(ess > 20), ess


def test_multichain_sums_per_chain():
    rng = np.random.default_rng(4)
    x = np.stack([ar1_samples(rng, 800, 2, rho=0.6) for _ in range(3)])
    total = ess_multichain(x)
    per = np.stack([ess_geyer(x[i]) for i in range(3)])
    np.testing.assert_allclose(total, per.sum(axis=0), rtol=1e-12)


def test_native_ess_matches_numpy_exact_mode():
    from riemannhamiltonianmontecarlo.diagnostics import native

    if not native.available():
        pytest.skip("native ESS library not built")
    rng = np.random.default_rng(9)
    x = ar1_samples(rng, 2000, 5, rho=0.85)
    got = native.ess_geyer_native(x)
    expected = ess_geyer(x, nfft_mode="exact")
    np.testing.assert_allclose(got, expected, rtol=1e-10)

    stacked = np.stack([x, x[::-1]])
    got3 = native.ess_geyer_native(stacked)
    from riemannhamiltonianmontecarlo.diagnostics import ess_multichain

    np.testing.assert_allclose(
        got3, ess_multichain(stacked, nfft_mode="exact"), rtol=1e-10
    )


def test_device_ess_matches_numpy_exact():
    import jax.numpy as jnp

    from riemannhamiltonianmontecarlo.diagnostics import ess_geyer_device

    rng = np.random.default_rng(12)
    x = ar1_samples(rng, 1500, 3, rho=0.8)
    got = np.asarray(ess_geyer_device(jnp.asarray(x, jnp.float32)))
    expected = ess_geyer(x, nfft_mode="exact")
    np.testing.assert_allclose(got, expected, rtol=2e-2)

    stacked = np.stack([x, x * 0.5 + 1.0])
    got3 = np.asarray(ess_geyer_device(jnp.asarray(stacked, jnp.float32)))
    np.testing.assert_allclose(got3, ess_multichain(stacked, nfft_mode="exact"), rtol=2e-2)


def test_geweke_z_stationary_vs_drifting():
    from riemannhamiltonianmontecarlo.diagnostics import geweke_z

    rng = np.random.default_rng(0)
    stationary = rng.normal(size=(4000, 3))
    z = geweke_z(stationary)
    assert z.shape == (3,)
    assert np.all(np.abs(z) < 4.0), z

    drifting = stationary + np.linspace(0.0, 5.0, 4000)[:, None]
    zd = geweke_z(drifting)
    assert np.all(np.abs(zd) > 5.0), zd

    # chain-axis form
    zc = geweke_z(np.stack([stationary, drifting]))
    assert zc.shape == (2, 3)
    assert np.abs(zc[0]).max() < 4.0 < np.abs(zc[1]).min()


def test_device_ess_chunked_matches_unchunked():
    """Tiny max_bytes forces the parameter-chunked FFT path (OOM guard)."""
    import jax.numpy as jnp

    from riemannhamiltonianmontecarlo.diagnostics import ess_geyer_device

    rng = np.random.default_rng(5)
    x = jnp.asarray(np.stack([ar1_samples(rng, 400, 7, rho=0.6) for _ in range(3)]),
                    jnp.float32)
    full = np.asarray(ess_geyer_device(x))
    chunked = np.asarray(ess_geyer_device(x, max_bytes=3 * 8 * 1024 * 2))  # chunk=2
    np.testing.assert_allclose(chunked, full, rtol=1e-5)


def test_device_ess_parts_matches_full():
    """Segment-parts ESS (never materializes the full tensor) == full-tensor
    ESS, including when a tiny max_bytes forces coordinate chunking and
    when the input arrives as host numpy (round-4: StochVol kept samples
    live only as per-segment device parts)."""
    import jax.numpy as jnp

    from riemannhamiltonianmontecarlo.diagnostics.ess import (
        ess_geyer_device,
        ess_geyer_device_parts,
    )

    rng = np.random.default_rng(6)
    x = np.stack([ar1_samples(rng, 512, 9, rho=0.7) for _ in range(4)]).astype(
        np.float32)
    parts = [jnp.asarray(x[:, :200]), jnp.asarray(x[:, 200:350]),
             jnp.asarray(x[:, 350:])]
    full = np.asarray(ess_geyer_device(jnp.asarray(x)))
    np.testing.assert_allclose(ess_geyer_device_parts(parts), full, rtol=1e-3)
    np.testing.assert_allclose(
        ess_geyer_device_parts(parts, max_bytes=1 << 18), full, rtol=1e-3)
    # numpy-input path of the full-tensor variant (host-side demean + chunked
    # device FFT) agrees too
    np.testing.assert_allclose(np.asarray(ess_geyer_device(x)), full, rtol=1e-3)

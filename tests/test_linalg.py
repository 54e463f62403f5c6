"""Chain-batched linalg vs NumPy/LAPACK references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riemannhamiltonianmontecarlo import ops


@pytest.fixture(scope="module", params=[3, 15, 24])
def batch_psd(request):
    d = request.param
    rng = np.random.default_rng(d)
    a = rng.normal(size=(16, d, d))
    psd = a @ np.swapaxes(a, -1, -2) + d * np.eye(d)
    return jnp.asarray(psd, dtype=jnp.float32)


def test_cholesky_matches_numpy(batch_psd):
    l = np.asarray(ops.cholesky(batch_psd))
    expected = np.linalg.cholesky(np.asarray(batch_psd, dtype=np.float64))
    np.testing.assert_allclose(l, expected, rtol=5e-4, atol=5e-4)
    # strictly lower-triangular above diagonal
    assert np.allclose(np.triu(l, 1), 0.0)


def test_solves(batch_psd):
    d = batch_psd.shape[-1]
    key = jax.random.key(0)
    b = jax.random.normal(key, (batch_psd.shape[0], d))
    l = ops.cholesky(batch_psd)

    y = ops.solve_lower_triangular(l, b)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", np.asarray(l), np.asarray(y)), b, rtol=2e-3, atol=2e-3
    )

    x = ops.cho_solve(l, b)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", np.asarray(batch_psd), np.asarray(x)),
        b,
        rtol=2e-3,
        atol=2e-3,
    )

    x2 = ops.solve_psd(batch_psd, b)
    np.testing.assert_allclose(x2, x, rtol=1e-5, atol=1e-5)


def test_matrix_rhs_solve(batch_psd):
    d = batch_psd.shape[-1]
    key = jax.random.key(1)
    b = jax.random.normal(key, (batch_psd.shape[0], d, 4))
    x = ops.solve_psd(batch_psd, b)
    np.testing.assert_allclose(
        np.einsum("bij,bjk->bik", np.asarray(batch_psd), np.asarray(x)),
        b,
        rtol=2e-3,
        atol=2e-3,
    )


def test_inverse_and_logdet(batch_psd):
    d = batch_psd.shape[-1]
    inv = np.asarray(ops.inv_psd(batch_psd))
    a64 = np.asarray(batch_psd, dtype=np.float64)
    np.testing.assert_allclose(inv, np.linalg.inv(a64), rtol=2e-3, atol=2e-3)

    l = ops.cholesky(batch_psd)
    ld = np.asarray(ops.logdet_from_chol(l))
    np.testing.assert_allclose(ld, np.linalg.slogdet(a64)[1], rtol=2e-4, atol=1e-3)


def test_unrolled_matches_xla_path(batch_psd):
    l_unrolled = ops.cholesky(batch_psd, method="unrolled")
    l_xla = ops.cholesky(batch_psd, method="xla")
    np.testing.assert_allclose(l_unrolled, l_xla, rtol=5e-4, atol=5e-4)


def test_mvn_sample_covariance():
    d = 4
    rng = np.random.default_rng(7)
    a = rng.normal(size=(d, d))
    cov = a @ a.T + d * np.eye(d)
    l = ops.cholesky(jnp.asarray(cov, dtype=jnp.float32))
    z = ops.mvn_sample(jax.random.key(5), l, shape=(200_000,))
    emp = np.cov(np.asarray(z).T)
    np.testing.assert_allclose(emp, cov, rtol=3e-2, atol=3e-2 * np.max(np.abs(cov)))

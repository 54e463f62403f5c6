"""Tridiagonal ops vs dense NumPy references."""

import jax.numpy as jnp
import numpy as np
import pytest

from riemannhamiltonianmontecarlo.ops import tridiag


def make_system(rng, batch, t):
    off = rng.normal(size=(batch, t - 1)) * 0.4
    diag = 2.0 + rng.uniform(size=(batch, t))  # diagonally dominant PD
    b = rng.normal(size=(batch, t))
    return diag, off, b


def dense(diag, off):
    t = diag.shape[-1]
    m = np.zeros((t, t))
    np.fill_diagonal(m, diag)
    m[np.arange(t - 1), np.arange(1, t)] = off
    m[np.arange(1, t), np.arange(t - 1)] = off
    return m


@pytest.mark.parametrize("t", [7, 64, 2000])
def test_solve_pcr(t):
    rng = np.random.default_rng(t)
    diag, off, b = make_system(rng, 4, t)
    x = np.asarray(tridiag.solve(jnp.asarray(diag), jnp.asarray(off), jnp.asarray(b)))
    for i in range(4):
        expected = np.linalg.solve(dense(diag[i], off[i]), b[i])
        np.testing.assert_allclose(x[i], expected, rtol=2e-4, atol=2e-4)


def test_cholesky_and_logdet():
    rng = np.random.default_rng(0)
    diag, off, _ = make_system(rng, 3, 50)
    chol = tridiag.cholesky(jnp.asarray(diag), jnp.asarray(off))
    for i in range(3):
        m = dense(diag[i], off[i])
        l_dense = np.linalg.cholesky(m)
        np.testing.assert_allclose(np.asarray(chol.ld)[i], np.diag(l_dense), rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(chol.e)[i], np.diag(l_dense, -1), rtol=1e-5, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(tridiag.logdet_from_chol(chol))[i],
            np.linalg.slogdet(m)[1],
            rtol=1e-5,
        )


def test_matvecs():
    rng = np.random.default_rng(1)
    diag, off, b = make_system(rng, 3, 33)
    got = np.asarray(tridiag.matvec(jnp.asarray(diag), jnp.asarray(off), jnp.asarray(b)))
    for i in range(3):
        np.testing.assert_allclose(got[i], dense(diag[i], off[i]) @ b[i], rtol=1e-5)

    chol = tridiag.cholesky(jnp.asarray(diag), jnp.asarray(off))
    z = rng.normal(size=(3, 33))
    lz = np.asarray(tridiag.matvec_chol(chol, jnp.asarray(z)))
    for i in range(3):
        l_dense = np.linalg.cholesky(dense(diag[i], off[i]))
        np.testing.assert_allclose(lz[i], l_dense @ z[i], rtol=1e-4, atol=1e-5)

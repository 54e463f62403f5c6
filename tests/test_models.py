"""Unit tests for the BLR model: closed forms vs autodiff and dense math.

Mirrors the reference's implicit verification strategy (SURVEY.md section
4): the analytic gradient / metric / dG contractions must equal what
autodiff derives from the log joint and what a dense NumPy rebuild of the
formulas at ``code/rmhmc.py:50-77`` produces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riemannhamiltonianmontecarlo.models import (
    LogisticRegression,
    autodiff_manifold,
    synthetic_logreg,
)
from riemannhamiltonianmontecarlo.models.base import FunctionModel


@pytest.fixture(scope="module")
def model():
    ds = synthetic_logreg(seed=1, n=60, d=5)
    return LogisticRegression(jnp.asarray(ds.X), jnp.asarray(ds.t))


@pytest.fixture(scope="module")
def positions(model):
    key = jax.random.key(0)
    return 0.5 * jax.random.normal(key, (7, model.dim))


def dense_metric(model, w):
    X = np.asarray(model.X)
    p = 1.0 / (1.0 + np.exp(-X @ np.asarray(w)))
    v = p * (1 - p)
    return X.T @ (v[:, None] * X) + np.eye(X.shape[1]) / model.alpha


def dense_dg(model, w):
    """dG[d] = X^T diag(v (1-2p) X[:, d]) X -- reference code/rmhmc.py:63-77."""
    X = np.asarray(model.X)
    p = 1.0 / (1.0 + np.exp(-X @ np.asarray(w)))
    v = p * (1 - p)
    D = X.shape[1]
    out = np.zeros((D, D, D))
    for d in range(D):
        z = v * (1 - 2 * p) * X[:, d]
        out[d] = X.T @ (z[:, None] * X)
    return out


def test_grad_matches_autodiff(model, positions):
    ad_grad = jax.vmap(jax.grad(lambda w: model.logp(w)))(positions)
    np.testing.assert_allclose(model.grad(positions), ad_grad, rtol=2e-4, atol=2e-5)


def test_logp_and_grad_consistent(model, positions):
    lp, g = model.logp_and_grad(positions)
    np.testing.assert_allclose(lp, model.logp(positions), rtol=1e-6)
    np.testing.assert_allclose(g, model.grad(positions), rtol=1e-6)


def test_metric_matches_dense(model, positions):
    got = np.asarray(model.metric(positions))
    for i, w in enumerate(np.asarray(positions)):
        np.testing.assert_allclose(got[i], dense_metric(model, w), rtol=1e-4, atol=1e-5)


def test_dg_contractions_match_dense(model, positions):
    key = jax.random.key(3)
    d = model.dim
    u = jax.random.normal(key, positions.shape)
    v = jax.random.normal(jax.random.fold_in(key, 1), positions.shape)
    m_raw = jax.random.normal(jax.random.fold_in(key, 2), (positions.shape[0], d, d))
    m = 0.5 * (m_raw + jnp.swapaxes(m_raw, -1, -2))

    bil = np.asarray(model.dg_bilinear(positions, u, v))
    tra = np.asarray(model.dg_trace(positions, m))
    dot = np.asarray(model.dg_dotted(positions, m))

    for i, w in enumerate(np.asarray(positions)):
        dg = dense_dg(model, w)
        ui, vi, mi = np.asarray(u[i]), np.asarray(v[i]), np.asarray(m[i])
        np.testing.assert_allclose(
            bil[i], np.einsum("dab,a,b->d", dg, ui, vi), rtol=2e-3, atol=2e-3
        )
        np.testing.assert_allclose(
            tra[i], np.einsum("dab,ba->d", dg, mi), rtol=2e-3, atol=2e-3
        )
        np.testing.assert_allclose(
            dot[i], np.einsum("ia,eab,be->i", mi, dg, mi), rtol=2e-3, atol=2e-3
        )


def test_autodiff_manifold_agrees_with_closed_form(model, positions):
    """Generic jacfwd-based manifold ops must match the closed forms."""
    base = FunctionModel(dim=model.dim, logp_fn=lambda w: model.logp(w))
    generic = autodiff_manifold(base, lambda w: model.metric(w))
    w = positions[:3]
    key = jax.random.key(9)
    u = jax.random.normal(key, w.shape)
    m = jnp.broadcast_to(jnp.eye(model.dim), (3, model.dim, model.dim))
    np.testing.assert_allclose(
        generic.dg_bilinear(w, u, u), model.dg_bilinear(w, u, u), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        generic.dg_trace(w, m), model.dg_trace(w, m), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        generic.dg_dotted(w, m), model.dg_dotted(w, m), rtol=2e-3, atol=2e-3
    )


def test_iwls_proposal_matches_reference_formula(model, positions):
    """cov = G^{-1}; mean = cov X^T W z, z = Xw + W^{-1}(t-p) -- code/iwls.py:28-35."""
    w = positions[0]
    X, t = np.asarray(model.X), np.asarray(model.t)
    wn = np.asarray(w)
    p = 1.0 / (1.0 + np.exp(-X @ wn))
    W = p * (1 - p)
    cov = np.linalg.inv(np.eye(model.dim) / model.alpha + X.T @ (W[:, None] * X))
    z = X @ wn + (t - p) / W
    mean = cov @ (X.T @ (W * z))
    got_mean, got_cov = model.iwls_proposal(w)
    np.testing.assert_allclose(got_cov, cov, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(got_mean, mean, rtol=2e-3, atol=1e-4)

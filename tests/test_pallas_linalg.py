"""Pallas (Triton) chains-last linalg kernels: interpret mode on CPU, the
wrapper's padding, and the dispatcher's choice of kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riemannhamiltonianmontecarlo import ops
from riemannhamiltonianmontecarlo.ops import pallas_linalg as plin


def _psd_batch(c, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c, d, d))
    g = jnp.asarray(a @ np.swapaxes(a, -1, -2) + d * np.eye(d), jnp.float32)
    b = jnp.asarray(rng.normal(size=(c, d)), jnp.float32)
    return g, b


@pytest.fixture(scope="module", params=[(5, 7), (200, 15), (130, 25)])
def batch(request):
    c, d = request.param
    return _psd_batch(c, d, c + d)


def test_pallas_cholesky(batch):
    g, _ = batch
    l = np.asarray(plin.cholesky(g, interpret=True))
    expected = np.linalg.cholesky(np.asarray(g, np.float64))
    np.testing.assert_allclose(l, expected, rtol=2e-4, atol=2e-4)
    assert np.allclose(np.triu(l, 1), 0.0)


def test_pallas_fused_solve_logdet(batch):
    g, b = batch
    x, ld = plin.chol_solve_logdet(g, b, interpret=True)
    g64 = np.asarray(g, np.float64)
    xe = np.linalg.solve(g64, np.asarray(b)[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(x), xe, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(ld), np.linalg.slogdet(g64)[1], rtol=2e-4, atol=2e-3
    )


@pytest.mark.parametrize("c", [1, 128, 129])
def test_chains_last_pads_with_identity(c):
    d = 3
    g, _ = _psd_batch(c, d, c)
    gt, cp = plin._chains_last(g)
    assert cp % plin.BLOCK_C == 0 and c <= cp < c + plin.BLOCK_C
    assert gt.shape == (d * d, cp)
    np.testing.assert_array_equal(np.asarray(gt[:, :c]).T.reshape(c, d, d), np.asarray(g))
    pad = np.asarray(gt[:, c:]).T.reshape(cp - c, d, d)
    np.testing.assert_array_equal(pad, np.broadcast_to(np.eye(d), pad.shape))


def test_linalg_dispatch_pallas():
    """Off the GPU the dispatcher runs the plain path: same numbers as the
    unrolled graph."""
    g, b = _psd_batch(40, 6, 3)
    np.testing.assert_allclose(
        ops.cholesky(g), ops.cholesky(g, method="unrolled"), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        ops.solve_psd(g, b), ops.solve_psd(g, b, method="unrolled"), rtol=1e-6, atol=1e-6,
    )


def _lowered_for(fn, *args, platform):
    exp = jax.export.export(
        jax.jit(fn), platforms=[platform],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(*args)
    return exp.mlir_module()


@pytest.mark.parametrize("d", [8, 15, 16, 17, 25])
def test_kernel_chosen_by_dim_on_cuda(d):
    """Lowered for CUDA, D <= MAX_DIM calls the Triton kernel for the factor
    and the fused solve; larger D and the CPU lowering do not."""
    g, b = _psd_batch(8, d, d)
    want = d <= plin.MAX_DIM
    assert ops.linalg.uses_kernel(d) == want
    for fn, args in ((ops.cholesky, (g,)), (ops.solve_psd, (g, b))):
        cuda = _lowered_for(fn, *args, platform="cuda")
        assert ("__gpu$xla.gpu.triton" in cuda) == want
        assert "__gpu$xla.gpu.triton" not in _lowered_for(fn, *args, platform="cpu")


def test_kernel_not_used_for_unbatched_or_matrix_rhs():
    g, b = _psd_batch(4, 5, 0)
    cuda = _lowered_for(lambda a: ops.cholesky(a[0]), g, platform="cuda")
    assert "__gpu$xla.gpu.triton" not in cuda
    rhs = jnp.stack([b, b], axis=-1)  # (C, D, 2)
    cuda = _lowered_for(ops.solve_psd, g, rhs, platform="cuda")
    assert "__gpu$xla.gpu.triton" not in cuda


def test_kernel_partitions_over_chain_mesh():
    """Chain-sharded inputs: each device factors its own chains, with no
    gather of the batch, and the results match the unsharded call."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    g, b = _psd_batch(512, 6, 1)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("chains",))
    gs, bs = (jax.device_put(a, NamedSharding(mesh, P("chains"))) for a in (g, b))

    def both(g, b):
        return (plin.cholesky(g, interpret=True),) + plin.chol_solve_logdet(g, b, interpret=True)

    fn = jax.jit(both)
    for got, want in zip(fn(gs, bs), both(g, b)):
        assert len(got.sharding.device_set) == 4
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert "all-gather" not in fn.lower(gs, bs).compile().as_text()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 15])
def test_compiled_kernel_matches_numpy(gpu, d):
    g, b = _psd_batch(4096 + 3, d, d)
    g64 = np.asarray(g, np.float64)
    np.testing.assert_allclose(np.asarray(plin.cholesky(g)), np.linalg.cholesky(g64),
                               rtol=2e-4, atol=2e-4)
    x, ld = plin.chol_solve_logdet(g, b)
    np.testing.assert_allclose(
        np.asarray(x), np.linalg.solve(g64, np.asarray(b, np.float64)[..., None])[..., 0],
        rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(ld), np.linalg.slogdet(g64)[1], rtol=2e-4, atol=2e-3)

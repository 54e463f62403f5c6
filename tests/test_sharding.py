"""Mesh-sharded chain execution on the 8-device virtual CPU backend.

Determinism contract (SURVEY.md section 5, race-detection analog): the
same seed must produce the same chains regardless of how the chain axis
is sharded, which JAX's partitionable threefry guarantees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riemannhamiltonianmontecarlo.parallel import make_mesh, run
from riemannhamiltonianmontecarlo.samplers import hmc


class IsoGaussian:
    dim = 2

    def logp(self, w):
        return -0.5 * jnp.sum(w * w, axis=-1)

    def grad(self, w):
        return -w

    def logp_and_grad(self, w):
        return self.logp(w), self.grad(w)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_run_matches_unsharded():
    model = IsoGaussian()
    kernel = hmc.build(model, hmc.HMCConfig(step_size=0.3, num_leapfrog=6))
    init = jnp.zeros((32, 2))
    key = jax.random.key(0)

    res_plain = run(kernel, key, init, num_samples=40, burn_in=5)
    mesh = make_mesh()
    res_mesh = run(kernel, key, init, num_samples=40, burn_in=5, mesh=mesh)

    np.testing.assert_allclose(
        np.asarray(res_plain.samples), np.asarray(res_mesh.samples), rtol=1e-5, atol=1e-5
    )


def test_sharded_samples_are_distributed():
    model = IsoGaussian()
    kernel = hmc.build(model, hmc.HMCConfig(step_size=0.3, num_leapfrog=4))
    mesh = make_mesh()
    init = jnp.zeros((16, 2))
    res = run(kernel, jax.random.key(1), init, num_samples=10, burn_in=0, mesh=mesh)
    shards = res.samples.sharding.device_set
    assert len(shards) == 8


def test_lgc_latent_sharded_matches_replicated():
    """Long-context axis (SURVEY.md section 5): the LGC D=1024 dense
    operators sharded over a 'latent' mesh axis (rows of Sigma^{-1} /
    G^{-1} / chol G distributed, matvecs psum over the axis) must
    reproduce the replicated run."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from riemannhamiltonianmontecarlo.models import lgc as lgc_model
    from riemannhamiltonianmontecarlo.samplers import phmc

    n = 32  # D = 1024
    y, _ = lgc_model.generate_data(seed=0, n=n)
    model = lgc_model.LGCModel(jnp.asarray(y, jnp.float32), n=n)
    cfg = phmc.PHMCConfig(step_size=0.05, num_leapfrog=3)
    init = jnp.tile(model.prior_mean(), (8, 1))

    kernel = phmc.build(model, model.metric_chol, model.metric_inv, cfg)
    res_plain = run(kernel, jax.random.key(0), init, num_samples=6, burn_in=0)

    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("chains", "latent"))
    sm = model.with_sharding(mesh)
    # Operators really are distributed: half the rows per latent shard.
    assert sm.sigma_inv.sharding.shard_shape(sm.sigma_inv.shape) == (512, 1024)
    kernel_s = phmc.build(sm, sm.metric_chol, sm.metric_inv, cfg)
    init_s = jax.device_put(init, NamedSharding(mesh, P("chains", "latent")))
    res_sharded = run(kernel_s, jax.random.key(0), init_s, num_samples=6, burn_in=0)

    np.testing.assert_allclose(
        np.asarray(res_plain.samples), np.asarray(res_sharded.samples),
        rtol=1e-3, atol=1e-3,
    )
    assert float(res_plain.accept_rate) == pytest.approx(
        float(res_sharded.accept_rate), abs=1e-3)  # f32 reduction order


def test_blr_data_sharded_matches_replicated():
    """Tensor-parallel data axis (SURVEY.md section 2.4 TP row): the BLR
    design matrix row-sharded over a 'data' mesh axis (N=690 zero-padded
    to 696 = 8 x 87; X^T diag(v) X and every other n-contraction psum
    over the axis) must reproduce the replicated model exactly."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from riemannhamiltonianmontecarlo.models import datasets, logreg
    from riemannhamiltonianmontecarlo.samplers import rmhmc

    ds = datasets.load_dataset("australian")
    x, t = ds.X, ds.t
    model = logreg.LogisticRegression(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(t, jnp.float32))
    mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("data",))
    sm = model.with_sharding(mesh)
    assert sm.X.shape[0] % 8 == 0
    assert sm.X.sharding.shard_shape(sm.X.shape)[0] == sm.X.shape[0] // 8

    w = jax.random.normal(jax.random.key(7), (16, model.dim)) * 0.2

    ms_plain = jax.jit(model.manifold_state)(w)
    ms_shard = jax.jit(sm.manifold_state)(w)
    np.testing.assert_allclose(np.asarray(ms_plain.logp),
                               np.asarray(ms_shard.logp), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ms_plain.grad),
                               np.asarray(ms_shard.grad), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(ms_plain.metric),
                               np.asarray(ms_shard.metric), rtol=2e-4, atol=2e-4)

    # Full manifold kernel end-to-end on the sharded model.
    cfg = rmhmc.RMHMCConfig(step_size=0.5, num_leapfrog=2, num_fixed_point=4)
    res_plain = run(rmhmc.build(model, cfg), jax.random.key(0), w,
                    num_samples=5, burn_in=0)
    res_shard = run(rmhmc.build(sm, cfg), jax.random.key(0), w,
                    num_samples=5, burn_in=0)
    np.testing.assert_allclose(np.asarray(res_plain.samples),
                               np.asarray(res_shard.samples),
                               rtol=5e-3, atol=5e-3)


def test_blr_two_axis_chains_by_data():
    """2-axis mesh: chains sharded over 'chains' AND the design matrix
    over 'data' in the same jit -- the DP x TP layout for huge-N BLR."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from riemannhamiltonianmontecarlo.models import datasets, logreg
    from riemannhamiltonianmontecarlo.samplers import mala

    ds = datasets.load_dataset("heart")
    x, t = ds.X, ds.t
    model = logreg.LogisticRegression(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(t, jnp.float32))
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("chains", "data"))
    sm = model.with_sharding(mesh)
    init = jnp.zeros((8, model.dim))
    init_s = jax.device_put(init, NamedSharding(mesh, P("chains", None)))

    cfg = mala.MALAConfig(step_size=0.05)
    res_plain = run(mala.build(model, cfg), jax.random.key(1), init,
                    num_samples=8, burn_in=0)
    res_shard = run(mala.build(sm, cfg), jax.random.key(1), init_s,
                    num_samples=8, burn_in=0)
    np.testing.assert_allclose(np.asarray(res_plain.samples),
                               np.asarray(res_shard.samples),
                               rtol=1e-4, atol=1e-4)


def test_monitor_wrapper_runs(capfd):
    from riemannhamiltonianmontecarlo.parallel import monitor

    model = IsoGaussian()
    kernel = monitor(hmc.build(model, hmc.HMCConfig(step_size=0.3, num_leapfrog=4)), every=5)
    res = run(kernel, jax.random.key(2), jnp.zeros((8, 2)), num_samples=12, burn_in=0)
    assert np.isfinite(np.asarray(res.samples)).all()

"""Checkpoint round-trip: stop and resume a run bit-exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from riemannhamiltonianmontecarlo.parallel import run
from riemannhamiltonianmontecarlo.samplers import hmc
from riemannhamiltonianmontecarlo.utils.checkpoint import load_state, save_state

from targets import ConstantMetricGaussian


def test_checkpoint_roundtrip_resume(tmp_path):
    target = ConstantMetricGaussian(mean=[0.0, 1.0], cov=np.eye(2))
    kernel = hmc.build(target, hmc.HMCConfig(step_size=0.3, num_leapfrog=5))
    init = jnp.zeros((16, 2))
    key = jax.random.key(0)
    k1, k2 = jax.random.split(key)

    # One continuous run...
    mid = run(kernel, k1, init, num_samples=20, burn_in=0)
    full = run(kernel, k2, None, num_samples=30, burn_in=0, init_state=mid.final_state)

    # ...vs save/restore at the midpoint.
    path = tmp_path / "ckpt.npz"
    save_state(path, mid.final_state, step=20, key=k2)
    template = kernel.init(init)
    restored, step, rkey = load_state(path, template)
    assert step == 20
    resumed = run(kernel, rkey, None, num_samples=30, burn_in=0, init_state=restored)

    np.testing.assert_array_equal(np.asarray(full.samples), np.asarray(resumed.samples))


def test_run_checkpointed_crash_resume_bit_exact(tmp_path):
    """A run killed mid-way resumes from the last segment and produces
    samples bit-identical to the uninterrupted segmented run."""
    from riemannhamiltonianmontecarlo.parallel import run_checkpointed

    target = ConstantMetricGaussian(mean=[0.0, 1.0], cov=np.eye(2))
    kernel = hmc.build(target, hmc.HMCConfig(step_size=0.3, num_leapfrog=5))
    init = jnp.zeros((16, 2))
    key = jax.random.key(7)

    full = run_checkpointed(
        kernel, key, init, num_samples=50, burn_in=10,
        checkpoint_path=tmp_path / "a" / "ckpt.npz", checkpoint_every=10)
    assert full.samples.shape == (16, 50, 2)

    # Simulated crash after 2 of 5 segments...
    crashed = run_checkpointed(
        kernel, key, init, num_samples=50, burn_in=10,
        checkpoint_path=tmp_path / "b" / "ckpt.npz", checkpoint_every=10,
        _stop_after_segments=2)
    assert crashed.samples.shape == (16, 20, 2)
    # ...then a plain re-invocation resumes from segment 2.
    resumed = run_checkpointed(
        kernel, key, init, num_samples=50, burn_in=10,
        checkpoint_path=tmp_path / "b" / "ckpt.npz", checkpoint_every=10)
    np.testing.assert_array_equal(np.asarray(full.samples), np.asarray(resumed.samples))
    assert int(resumed.divergences) == 0


def test_run_checkpointed_collect_fn_pytree(tmp_path):
    """Segments of a non-trivial collect_fn pytree reassemble correctly."""
    from riemannhamiltonianmontecarlo.parallel import run_checkpointed

    target = ConstantMetricGaussian(mean=[0.0, 1.0], cov=np.eye(2))
    kernel = hmc.build(target, hmc.HMCConfig(step_size=0.3, num_leapfrog=5))
    res = run_checkpointed(
        kernel, jax.random.key(1), jnp.zeros((8, 2)), num_samples=25, burn_in=5,
        checkpoint_path=tmp_path / "ckpt.npz", checkpoint_every=10,
        collect_fn=lambda st: (st.position, st.position[:, 0]))
    a, b = res.samples
    assert a.shape == (8, 25, 2) and b.shape == (8, 25)
    np.testing.assert_array_equal(np.asarray(a[:, :, 0]), np.asarray(b))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    target = ConstantMetricGaussian(mean=[0.0, 1.0], cov=np.eye(2))
    kernel = hmc.build(target, hmc.HMCConfig())
    state = kernel.init(jnp.zeros((8, 2)))
    path = tmp_path / "ckpt.npz"
    save_state(path, state)
    wrong_template = kernel.init(jnp.zeros((4, 2)))
    try:
        load_state(path, wrong_template)
        raise AssertionError("expected ValueError")
    except ValueError:
        pass

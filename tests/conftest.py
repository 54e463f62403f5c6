"""Test harness: force an 8-device virtual CPU backend.

Tests run on the CPU: Pallas kernels in interpret mode, and the
mesh/sharding path on 8 virtual host devices (the standard JAX
fake-backend trick; SURVEY.md section 4 implication (d)).  Tests that
need a compiled GPU kernel carry the ``gpu`` marker, take the ``gpu``
fixture and skip here; run them on a GPU machine with
``JAX_PLATFORMS=cuda pytest -m gpu tests/``.
"""

import os
import sys
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_threefry_partitionable", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (tests marked ``gpu``)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda pytest -m gpu tests/")


# Heavy statistical tests (long-run moment parity, multi-minute workload
# smoke runs), marked ``slow`` centrally from measured durations on the
# 2-vCPU CI box so the fast gate `pytest -m "not slow"` stays < ~5 min.
# Full suite (~22 min): plain `pytest tests/`.
SLOW_TESTS = {
    # test_lgc.py
    "test_lgc_joint_mmala_matches_rmhmc_posterior",  # 245s
    "test_lgc_joint_sampler_small",  # 31s
    "test_lgc_joint_hyper_conditional_concentrates",  # long self-run oracle
    "test_lgc_mmala_small",  # 17s
    "test_lgc_whitened_mala",  # 15s
    "test_lgc_joint_hyper_geometry",  # 16s
    # test_ess.py
    "test_device_ess_chunked_matches_unchunked",  # 59s
    "test_device_ess_matches_numpy_exact",  # 29s
    # test_sharding.py
    "test_blr_data_sharded_matches_replicated",  # 53s
    "test_lgc_latent_sharded_matches_replicated",  # 34s
    "test_sharded_run_matches_unsharded",  # 13s
    "test_blr_two_axis_chains_by_data",  # 11s
    # test_gibbs.py
    "test_gibbs_blr_matches_hmc",  # 46s
    # test_fhn.py
    "test_fhn_comparator_kernels_smoke",  # 38s
    "test_rmhmc_posterior_near_truth",  # 33s
    "test_fhn_mmala_posterior_near_truth",  # 20s
    "test_grad_matches_finite_differences",  # 11s
    # test_experiments.py
    "test_run_workload_stochvol_small",  # 33s
    "test_run_workload_fhn_small",  # 22s
    "test_run_workload_lgc_small",  # 21s
    "test_run_experiment_hmc_small",  # 16s
    "test_run_repeated_aggregation",  # 12s
    "test_run_collect_fn_pytree",  # 11s
    "test_run_experiment_mala_warmup_phase",  # 11s
    "test_stochvol_mala_transient_schedule",  # 9s
    # test_stochvol.py
    "test_posterior_concentrates_near_truth",  # 27s
    "test_comparator_methods_run",  # 19+19+6s (3 params)
    "test_hyper_metric_pd_and_grad_finite",  # 10s
    # test_manifold_samplers.py
    "test_rmhmc_blr_matches_hmc",  # 15s
    "test_studentt_rmhmc_blr_matches_hmc",  # 13s
    # test_samplers_basic.py
    "test_hmc_blr_posterior_mode",  # 13s
    # test_pallas_linalg.py
    "test_pallas_fused_solve_logdet",  # 26s (batch2)
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = getattr(item, "originalname", None) or item.name
        if name in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)

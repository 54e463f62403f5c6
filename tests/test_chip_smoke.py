"""chip_smoke.py's checks, run on the CPU at toy size (the GPU run is the
script itself: ``python chip_smoke.py`` and ``python chip_smoke.py --multi``)."""

import jax
import pytest

import chip_smoke
from riemannhamiltonianmontecarlo.utils import compile_cache


def test_device_check_raises_without_gpu():
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.check_device(1)


def test_numpy_reference_matches_manifold_state():
    """The float64 NumPy logreg reference agrees with the float32 model."""
    chip_smoke.phase_precision()


def test_max_rel_err_is_normwise_per_chain():
    ref = [[1.0, 100.0], [2.0, 0.0]]
    got = [[1.5, 100.0], [2.0, 0.0]]
    assert chip_smoke.max_rel_err(got, ref) == pytest.approx(0.005)
    assert chip_smoke.max_rel_err([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)


def test_multi_blr_phase_on_four_virtual_devices():
    chip_smoke.phase_multi_blr(jax.devices()[:4], chains=16, transitions=2)


def test_multi_lgc_phase_on_four_virtual_devices():
    chip_smoke.phase_multi_lgc(jax.devices()[:4], chains=8, n=8, transitions=2)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # left to JAX


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = compile_cache.REPO_CACHE_DIR.parent
    assert got == str(repo / ".jax_cache")
    assert (repo / "chip_smoke.py").exists()


@pytest.mark.gpu
def test_linalg_phase_compiles_for_the_card(gpu):
    chip_smoke.phase_linalg()

"""Experiment driver: presets, runtime, and summary statistics."""

import numpy as np
import pytest

from riemannhamiltonianmontecarlo.experiments import SAMPLERS, build_kernel, run_experiment
from riemannhamiltonianmontecarlo.utils.config import reference_preset


def test_presets_reproduce_reference_constants():
    p = reference_preset("rmhmc")
    assert (p.num_iterations, p.burn_in) == (6000, 1000)
    assert p.sampler_kwargs == {"step_size": 0.5, "num_leapfrog": 6, "num_fixed_point": 4}
    # Per-dataset HMC step sizes (BLR_hmc.m:36,:72,:108,:138,:168).
    p = reference_preset("hmc")
    assert p.sampler_kwargs == {"step_size": 0.1, "num_leapfrog": 100}
    p = reference_preset("hmc", "german")
    assert p.sampler_kwargs == {"step_size": 0.05, "num_leapfrog": 100}
    p = reference_preset("hmc", "heart")
    assert p.sampler_kwargs == {"step_size": 0.14, "num_leapfrog": 100}
    p = reference_preset("mala")
    assert (p.num_iterations, p.burn_in) == (25000, 20000)


def test_run_experiment_hmc_small():
    res = run_experiment(
        "hmc",
        "australian",
        num_chains=16,
        num_samples=60,
        burn_in=30,
        sampler_overrides={"num_leapfrog": 10, "step_size": 0.1},
    )
    assert res.num_samples == 60
    assert res.ess_min > 0
    assert res.sampling_time_s > 0
    assert np.isfinite(res.posterior_mean).all()
    assert res.time_per_min_ess == pytest.approx(res.sampling_time_s / res.ess_min)
    assert "hmc on australian" in res.summary()


def test_run_experiment_mala_warmup_phase():
    res = run_experiment(
        "mala", "heart", num_chains=16, num_samples=80, burn_in=40
    )
    assert np.isfinite(res.posterior_mean).all()
    assert 0.0 <= res.accept_rate <= 1.0


def test_run_experiment_adaptive_step_size():
    """--adapt: dual-averaging warmup replaces the hand-tuned constant and
    lands acceptance near the optimal-scaling target."""
    from riemannhamiltonianmontecarlo.models import synthetic_logreg

    res = run_experiment(
        "mala", synthetic_logreg(seed=0, n=690, d=15, w_scale=0.5),
        num_chains=64, num_samples=200, burn_in=300, adapt=True,
    )
    assert res.adapted_step_size is not None and res.adapted_step_size > 0
    assert abs(res.accept_rate - 0.574) < 0.12, (res.accept_rate, res.adapted_step_size)
    assert np.isfinite(res.posterior_mean).all()


def test_all_samplers_buildable():
    import jax.numpy as jnp

    from riemannhamiltonianmontecarlo.models import LogisticRegression, synthetic_logreg

    ds = synthetic_logreg(seed=0, n=40, d=3)
    model = LogisticRegression(jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32))
    for name in SAMPLERS:
        kernel, warm = build_kernel(name, model, "australian", None)
        assert kernel.init is not None and kernel.step is not None


def test_run_repeated_aggregation():
    from riemannhamiltonianmontecarlo.experiments import run_repeated

    results, agg = run_repeated(
        "hmc",
        "australian",
        n_repeats=2,
        num_chains=8,
        num_samples=30,
        burn_in=10,
        sampler_overrides={"num_leapfrog": 5, "step_size": 0.1},
    )
    assert len(results) == 2
    mean, stderr = agg["ess_min"]
    assert mean > 0 and stderr >= 0
    assert set(agg) >= {"ess_min", "sampling_time_s", "time_per_min_ess"}


def test_run_collect_fn_pytree():
    """collect_fn records an arbitrary state pytree (e.g. StochVol theta+x)."""
    import jax
    import jax.numpy as jnp

    from riemannhamiltonianmontecarlo import models, parallel, utils
    from riemannhamiltonianmontecarlo.samplers import mala

    ds = models.synthetic_logreg(seed=0, n=32, d=4)
    model = models.LogisticRegression(jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32))
    kernel = mala.build(model, mala.MALAConfig(step_size=0.2))
    init = utils.default_init(model, jax.random.key(0), num_chains=6)

    res = parallel.run(
        kernel,
        jax.random.key(1),
        init,
        num_samples=8,
        burn_in=2,
        collect_fn=lambda st: {"w": st.position, "lp": st.logp},
    )
    assert res.samples["w"].shape == (6, 8, model.dim)
    assert res.samples["lp"].shape == (6, 8)

    # default path unchanged
    res2 = parallel.run(kernel, jax.random.key(1), init, num_samples=8, burn_in=2)
    assert res2.samples.shape == (6, 8, model.dim)


def test_run_workload_stochvol_small():
    from riemannhamiltonianmontecarlo.experiments import run_workload

    res = run_workload("stochvol", "mala", num_chains=8, num_samples=20, burn_in=10,
                       stochvol_obs=60)
    assert set(res.ess) == {"hyper", "latent"}
    assert res.ess["hyper"].shape == (3,)
    assert res.ess["latent"].shape == (60,)
    assert np.isfinite(res.sampling_time_s)
    assert "stochvol/mala" in res.summary()


def test_stochvol_mala_transient_schedule():
    """StochVol MALA runs the transient-phase step sizes during burn-in
    (StochVol_MALA.m:62-67) and switches to stationary at the boundary
    (:279-283)."""
    from riemannhamiltonianmontecarlo.experiments import build_workload, run_workload

    kernel, _, _, _, warm = build_workload("stochvol", "mala", stochvol_obs=60)
    assert warm is not None
    # Transient eps = 0.05/sqrt(T) differs from stationary 0.03/T^(1/3):
    # the two kernels must be distinct closures over different configs.
    assert warm.step is not kernel.step

    res = run_workload("stochvol", "mala", num_chains=8, num_samples=20, burn_in=10,
                       stochvol_obs=60)
    assert np.isfinite(res.sampling_time_s)
    assert np.all(np.isfinite(res.ess["latent"]))


def test_run_workload_fhn_small():
    from riemannhamiltonianmontecarlo.experiments import run_workload

    res = run_workload("fhn", "mala", num_chains=4, num_samples=10, burn_in=4,
                       fhn_obs=30, fhn_substeps=2)
    assert res.ess["params"].shape == (3,)


def test_run_workload_lgc_small():
    from riemannhamiltonianmontecarlo.experiments import run_workload

    res = run_workload("lgc", "rmhmc", num_chains=4, num_samples=16, burn_in=8, lgc_n=8)
    assert res.ess["latent"].shape == (64,)
    res_w = run_workload("lgc", "mala_stationary", num_chains=4, num_samples=16,
                         burn_in=8, lgc_n=8)
    assert res_w.ess["latent"].shape == (64,)

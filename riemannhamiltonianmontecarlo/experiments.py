"""Experiment driver: the L3/L4 layer of the reference, as a library + CLI.

Replaces ``code/main.py`` (edit-the-source sampler selection, 10 serial
repeats) and the MATLAB ``Run_*_Experiments.m`` / ``CalculateStatistics.m``
pipeline with one call: build model + kernel from reference presets, run
chain-parallel on the available hardware, report the reference's summary
statistics (min/median/mean/max ESS, sampling-phase wall clock,
time-per-min-ESS -- ``code/main.py:70-79``, ``CalculateStatistics.m:24-31``).

Timing protocol: only the post-burn-in sampling phase is timed (the
reference convention, ``code/hmc.py:92-96``).  The sampling phase runs as
two identical half-scans; the first also pays XLA compilation, so the
reported time is twice the *second* half -- a steady-state measurement.

CLI::

    python -m riemannhamiltonianmontecarlo.experiments \
        --sampler rmhmc --dataset australian --chains 1024
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from riemannhamiltonianmontecarlo import diagnostics, models, parallel, samplers, utils
from riemannhamiltonianmontecarlo.utils.config import (
    MALA_STEP_SIZES,
    MALA_TRANSIENT_FACTOR,
    reference_preset,
)

SAMPLERS = (
    "metropolis",
    "hmc",
    "mala",
    "mmala",
    "mmala_simplified",
    "iwls",
    "gibbs",
    "rmhmc",
    "rmhmc_studentt",
)


@dataclasses.dataclass
class ExperimentResult:
    sampler: str
    dataset: str
    num_chains: int
    num_samples: int
    ess_min: float
    ess_median: float
    ess_mean: float
    ess_max: float
    sampling_time_s: float
    time_per_min_ess: float
    accept_rate: float
    divergences: int
    posterior_mean: np.ndarray
    posterior_std: np.ndarray
    rhat_max: float = float("nan")
    geweke_max_abs_z: float = float("nan")
    adapted_step_size: float | None = None  # set by --adapt runs
    samples: np.ndarray | None = None

    def summary(self) -> str:
        return (
            f"{self.sampler} on {self.dataset}: {self.num_chains} chains x "
            f"{self.num_samples} samples\n"
            f"  ESS (total over chains): min {self.ess_min:.0f}  median "
            f"{self.ess_median:.0f}  mean {self.ess_mean:.0f}  max {self.ess_max:.0f}\n"
            f"  sampling time: {self.sampling_time_s:.3f} s   "
            f"time/minESS: {self.time_per_min_ess:.3e} s   "
            f"accept: {self.accept_rate:.3f}   divergences: {self.divergences}   "
            f"max R-hat: {self.rhat_max:.4f}   max |Geweke z|: {self.geweke_max_abs_z:.2f}\n"
            f"  posterior mean[:5]: {np.round(self.posterior_mean[:5], 3)}"
        )


def build_kernel(name: str, model, dataset: str, overrides: dict[str, Any] | None = None):
    """(kernel, warmup_kernel_or_None) from reference presets."""
    kw = dict(reference_preset(name, dataset).sampler_kwargs)
    if overrides:
        kw.update(overrides)
    s = samplers
    if name == "metropolis":
        return s.metropolis.build(model, s.metropolis.AMHConfig()), None
    if name == "hmc":
        return s.hmc.build(model, s.hmc.HMCConfig(**kw)), None
    if name == "mala":
        step = kw.get("step_size", MALA_STEP_SIZES.get(dataset, 0.05))
        factor = MALA_TRANSIENT_FACTOR.get(dataset, 1.0)
        kernel = s.mala.build(model, s.mala.MALAConfig(step_size=step))
        warm = s.mala.build(
            model,
            s.mala.MALAConfig(step_size=step, transient=True, transient_factor=factor),
        )
        return kernel, warm
    if name == "mmala":
        return s.mmala.build(model, s.mmala.MMALAConfig(**kw)), None
    if name == "mmala_simplified":
        return s.mmala.build(model, s.mmala.MMALAConfig(simplified=True, **kw)), None
    if name == "iwls":
        return s.iwls.build(model), None
    if name == "gibbs":
        return s.gibbs.build(model), None
    if name == "rmhmc":
        return s.rmhmc.build(model, s.rmhmc.RMHMCConfig(**kw)), None
    if name == "rmhmc_studentt":
        return s.rmhmc.build(model, s.rmhmc.RMHMCConfig(student_t=True, **kw)), None
    raise KeyError(f"unknown sampler '{name}'; options: {SAMPLERS}")


# Samplers whose step size dual-averaging can adapt: (build_fn, config_cls,
# extra kwargs, optimal-scaling acceptance target).  Targets: 0.651 for
# HMC-family (Beskos et al. 2013), 0.574 for Langevin (Roberts &
# Rosenthal 1998).
def adaptive_parts(name: str, dataset: str, overrides: dict[str, Any] | None = None):
    """(build_fn, config, target_accept) for --adapt runs.

    Step size starts from a dimension-scaled guess, NOT the hand-tuned
    reference constant -- the point is zero per-dataset tuning.
    """
    kw = dict(reference_preset(name, dataset).sampler_kwargs)
    if overrides:
        kw.update(overrides)
    kw.pop("step_size", None)  # discard the hand-tuned constant
    s = samplers
    if name == "hmc":
        return s.hmc.build, s.hmc.HMCConfig(step_size=0.1, **kw), 0.651
    if name == "mala":
        return s.mala.build, s.mala.MALAConfig(step_size=0.1), 0.574
    if name == "mmala":
        return s.mmala.build, s.mmala.MMALAConfig(step_size=0.5, **kw), 0.574
    if name == "mmala_simplified":
        return s.mmala.build, s.mmala.MMALAConfig(step_size=0.5, simplified=True, **kw), 0.574
    if name == "rmhmc":
        return s.rmhmc.build, s.rmhmc.RMHMCConfig(step_size=0.1, **kw), 0.8
    if name == "rmhmc_studentt":
        return s.rmhmc.build, s.rmhmc.RMHMCConfig(step_size=0.1, student_t=True, **kw), 0.8
    raise KeyError(f"sampler '{name}' has no adaptable step size")


def _chained(kernel, key, position, init_state, steps: int, *, mesh, collect: bool,
             seg: int):
    """Run ``steps`` kernel steps in <=``seg``-step device calls, chained
    through ``init_state``.  Returns (final_state, samples_or_None,
    accept_rate, divergences).
    """
    state, outs, acc, div = init_state, [], 0.0, 0
    for i in range(0, steps, seg):
        n = min(seg, steps - i)
        r = parallel.run(
            kernel, jax.random.fold_in(key, i),
            position if state is None else None,
            num_samples=n, burn_in=0, collect=collect, init_state=state, mesh=mesh,
        )
        state = r.final_state
        if collect:
            outs.append(r.samples)
        acc += float(r.accept_rate) * n
        div += int(r.divergences)
        jax.block_until_ready(jax.tree.leaves(state)[0])
    samples = jnp.concatenate(outs, axis=1) if collect else None
    return state, samples, acc / max(steps, 1), div


def run_experiment(
    sampler: str,
    dataset: str | models.Dataset = "australian",
    *,
    num_chains: int = 1024,
    num_samples: int | None = None,
    burn_in: int | None = None,
    seed: int = 0,
    init: str = "map",
    mesh=None,
    ess_mode: str = "reference",
    keep_samples: bool = False,
    sampler_overrides: dict[str, Any] | None = None,
    adapt: bool = False,
    max_steps_per_call: int | None = None,
) -> ExperimentResult:
    """One BLR experiment at the reference preset.

    ``dataset`` is a reference dataset's name (loaded from its CSV) or a
    :class:`models.Dataset` such as ``models.synthetic_logreg(seed, n=690,
    d=15)``, which runs at australian's preset.
    """
    if isinstance(dataset, str):
        preset_name, ds = dataset, models.load_dataset(dataset)
    else:
        preset_name, ds = "australian", dataset
    preset = reference_preset(sampler, preset_name)
    num_samples = preset.num_samples if num_samples is None else num_samples
    burn_in = preset.burn_in if burn_in is None else burn_in

    model = models.LogisticRegression(
        jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32)
    )

    key = jax.random.key(seed)
    k_init, k_warm, k_a, k_b = jax.random.split(key, 4)
    if init == "map":
        position = utils.default_init(model, k_init, num_chains)
    elif init == "zeros":
        position = jnp.zeros((num_chains, model.dim))
    elif init == "reference":
        # code/rmhmc.py:27 uses 1e-3; code/hmc.py:27 zeros.
        position = jnp.full((num_chains, model.dim), 1e-3)
    else:
        raise ValueError(f"init must be map|zeros|reference, got {init!r}")

    half = max(num_samples // 2, 1)
    seg = max_steps_per_call or max(burn_in, half, 1)

    adapted_eps = None
    if adapt:
        # Dual-averaging warmup on pooled acceptance: no hand-tuned step.
        build_fn, cfg, target = adaptive_parts(sampler, preset_name, sampler_overrides)
        warm_kernel = parallel.adaptive(
            build_fn, model, cfg, parallel.AdaptationConfig(target_accept=target)
        )
        warm = parallel.run(
            warm_kernel, k_warm, position, num_samples=burn_in, burn_in=0,
            collect=False, mesh=mesh,
        )
        adapted_eps = parallel.frozen_step_size(warm.final_state)
        kernel = build_fn(model, dataclasses.replace(cfg, step_size=adapted_eps))
        warm_state = warm.final_state.inner
    else:
        kernel, warmup_kernel = build_kernel(sampler, model, preset_name, sampler_overrides)
        # The transient-phase kernel (e.g. MALA's 2 sqrt(D) scaling,
        # BLR_MALA.m:167) actually *steps* the burn-in; its state type
        # matches the stationary kernel's.
        warm_state, _, _, _ = _chained(
            warmup_kernel or kernel, k_warm, position, None, burn_in,
            mesh=mesh, collect=False, seg=seg,
        )
    jax.block_until_ready(warm_state.position)

    state_a, samples_a, acc_a, div_a = _chained(
        kernel, k_a, None, warm_state, half, mesh=mesh, collect=True, seg=seg)
    t0 = time.perf_counter()
    _, samples_b, acc_b, div_b = _chained(
        kernel, k_b, None, state_a, half, mesh=mesh, collect=True, seg=seg)
    t_half = time.perf_counter() - t0
    sampling_time = 2.0 * t_half

    accept = 0.5 * (acc_a + acc_b)
    div = div_a + div_b

    if ess_mode == "device":
        # Compute ESS and posterior moments on-device: only tiny arrays
        # cross to the host.  Alias-free ACF.
        dev_samples = jnp.concatenate([samples_a, samples_b], axis=1)
        ess = np.asarray(diagnostics.ess_geyer_device(dev_samples))
        rhat_max = float(jnp.max(diagnostics.split_rhat_device(dev_samples)))
        flat_mean = np.asarray(jnp.mean(dev_samples, axis=(0, 1)))
        flat_std = np.asarray(jnp.std(dev_samples, axis=(0, 1)))
        num_kept = int(dev_samples.shape[1])
        # Geweke stationarity check on a small chain subset (only a
        # (<=8, S, D) slice crosses to the host).
        geweke_max = float(
            np.abs(diagnostics.geweke_z(np.asarray(dev_samples[:8]))).max()
        )
        samples = np.asarray(dev_samples) if keep_samples else None
    else:
        samples = np.concatenate(
            [np.asarray(samples_a), np.asarray(samples_b)], axis=1
        )  # (C, S, D)
        if ess_mode == "native":
            # Threaded C++ engine (native/fastess.cpp): host-side Geyer ESS
            # over all C x D series at once -- the post-processing path for
            # C*P >> 1e4 where single-threaded NumPy FFTs dominate.
            ess = diagnostics.ess_geyer_native(samples)
        else:
            ess = diagnostics.ess_multichain(samples, nfft_mode=ess_mode)
        rhat_max = float(diagnostics.split_rhat(samples).max())
        geweke_max = float(np.abs(diagnostics.geweke_z(samples[:8])).max())
        flat = samples.reshape(-1, samples.shape[-1])
        flat_mean, flat_std = flat.mean(axis=0), flat.std(axis=0)
        num_kept = samples.shape[1]

    return ExperimentResult(
        sampler=sampler,
        dataset=ds.name,
        num_chains=num_chains,
        num_samples=num_kept,
        ess_min=float(ess.min()),
        ess_median=float(np.median(ess)),
        ess_mean=float(ess.mean()),
        ess_max=float(ess.max()),
        sampling_time_s=sampling_time,
        time_per_min_ess=sampling_time / float(ess.min()),
        accept_rate=accept,
        divergences=div,
        posterior_mean=flat_mean,
        posterior_std=flat_std,
        rhat_max=rhat_max,
        geweke_max_abs_z=geweke_max,
        adapted_step_size=adapted_eps,
        samples=samples if keep_samples else None,
    )


def aggregate(results: list[ExperimentResult]) -> dict[str, tuple[float, float]]:
    """Mean +- standard error over independent repeats.

    The reference aggregates 10 runs this way (``code/main.py:43-54``,
    ``Results/CalculateStatistics.m:7-31``).  Returns
    {stat: (mean, stderr)} for the ESS summary, sampling time, and
    time/minESS.
    """
    out: dict[str, tuple[float, float]] = {}
    n = len(results)
    for stat in (
        "ess_min",
        "ess_median",
        "ess_mean",
        "ess_max",
        "sampling_time_s",
        "time_per_min_ess",
        "accept_rate",
    ):
        vals = np.asarray([getattr(r, stat) for r in results], np.float64)
        out[stat] = (float(vals.mean()), float(vals.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0)
    return out


def run_repeated(
    sampler: str, dataset: str = "australian", *, n_repeats: int = 10, seed: int = 0, **kwargs
) -> tuple[list[ExperimentResult], dict[str, tuple[float, float]]]:
    """n independent repeats (different seeds) + CalculateStatistics-style
    aggregation."""
    results = [
        run_experiment(sampler, dataset, seed=seed + i, **kwargs)
        for i in range(n_repeats)
    ]
    return results, aggregate(results)


# --------------------------------------------------------------------------
# Non-BLR workloads: the reference's Run_* / RunFHN_* scripts as one driver.
# --------------------------------------------------------------------------

WORKLOAD_SAMPLERS = {
    "blr": SAMPLERS,
    "stochvol": ("rmhmc", "hmc", "mala", "mmala"),
    "lgc": ("rmhmc", "mmala", "mala_transient", "mala_stationary",
            "rmhmc_joint", "mmala_joint"),
    "fhn": ("rmhmc", "hmc", "mala", "mmala", "mmala_simplified", "metropolis"),
}


def timed_sampling(kernel, init, *, burn_in: int, num_samples: int, seed: int = 0,
                   collect_fn=None, warmup_kernel=None):
    """Two-half steady-state timing protocol (see module docstring).

    Returns (samples, accept_rate, divergences, sampling_time_s); samples
    concatenates both halves along the sample axis.
    """
    key = jax.random.key(seed)
    k_w, k_a, k_b = jax.random.split(key, 3)
    warm = parallel.run(kernel, k_w, init, num_samples=max(burn_in, 1), collect=False,
                        warmup_kernel=warmup_kernel)
    jax.block_until_ready(jax.tree.leaves(warm.final_state)[0])

    half = max(num_samples // 2, 1)
    res_a = parallel.run(kernel, k_a, None, num_samples=half,
                         init_state=warm.final_state, collect_fn=collect_fn)
    jax.block_until_ready(jax.tree.leaves(res_a.samples)[0])
    t0 = time.perf_counter()
    res_b = parallel.run(kernel, k_b, None, num_samples=half,
                         init_state=res_a.final_state, collect_fn=collect_fn)
    jax.block_until_ready(jax.tree.leaves(res_b.samples)[0])
    t = 2.0 * (time.perf_counter() - t0)

    samples = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=1),
                           res_a.samples, res_b.samples)
    accept = 0.5 * (float(res_a.accept_rate) + float(res_b.accept_rate))
    div = int(res_a.divergences) + int(res_b.divergences)
    return samples, accept, div, t


def build_workload(workload: str, sampler: str, *, overrides: dict[str, Any] | None = None,
                   seed: int = 0, stochvol_obs: int = 2000, lgc_n: int = 64,
                   fhn_obs: int = 200, fhn_substeps: int = 5):
    """(kernel, init_position_fn, collect_fn, groups_fn, warmup_kernel).

    All at reference constants.  ``groups_fn(samples) -> {group_name:
    (C, S, P) array}`` maps the raw collected pytree to the named
    quantities whose ESS the paper reports (e.g. StochVol hyperparameters
    vs latent volatilities, Tables 8/9).  ``warmup_kernel`` (or None) runs
    during burn-in only -- e.g. StochVol MALA's transient-phase step sizes.
    """
    kw = dict(overrides or {})
    s = samplers

    if workload == "stochvol":
        from riemannhamiltonianmontecarlo.models import stochvol as sv_model
        from riemannhamiltonianmontecarlo.samplers import stochvol as sv

        y, _ = sv_model.generate_data(seed=seed, num_obs=stochvol_obs)
        model = sv_model.StochVolModel(jnp.asarray(y, jnp.float32))
        t13 = stochvol_obs ** (1.0 / 3.0)
        t12 = stochvol_obs ** 0.5
        presets = {
            # StochVol_RMHMC.m:66-77
            "rmhmc": dict(),
            # StochVol_HMC.m:57-67
            "hmc": dict(method="hmc", latent_num_leapfrog=100, latent_step_size=0.03,
                        hyper_num_leapfrog=100, hyper_step_size=0.015),
            # StochVol_MALA.m stationary phase (:279-283): eps = StepSize/T^(1/3)
            "mala": dict(method="mala", latent_step_size=0.03 / t13,
                         hyper_step_size=0.005 / t13),
            # StochVol_mMALA.m:66-72
            "mmala": dict(method="mmala", latent_step_size=0.07, hyper_step_size=1.0),
        }
        cfg = sv.StochVolConfig(**{**presets[sampler], **kw})
        kernel = sv.build(model, cfg)

        warmup_kernel = None
        if sampler == "mala":
            # Transient phase (StochVol_MALA.m:62-67): eps = 0.05/T^(1/2)
            # latents, 0.01/T^(1/2) hypers, switched to the stationary
            # constants at the burn-in boundary (:279-283).
            warm_cfg = sv.StochVolConfig(**{**dict(
                method="mala", latent_step_size=0.05 / t12,
                hyper_step_size=0.01 / t12), **kw})
            warmup_kernel = sv.build(model, warm_cfg)

        def init_fn(chains: int):
            # (beta, sigma, phi) = 0.5, StochVol_RMHMC.m:86-89
            return jnp.tile(jnp.asarray([0.5, 0.5, 0.5], jnp.float32), (chains, 1))

        collect_fn = lambda st: (st.position, st.x)  # noqa: E731
        groups_fn = lambda smp: {"hyper": smp[0], "latent": smp[1]}  # noqa: E731
        return kernel, init_fn, collect_fn, groups_fn, warmup_kernel

    if workload == "lgc":
        from riemannhamiltonianmontecarlo.models import lgc as lgc_model
        from riemannhamiltonianmontecarlo.samplers import phmc

        y, _ = lgc_model.generate_data(seed=seed, n=lgc_n)

        if sampler in ("rmhmc_joint", "mmala_joint"):
            # Joint (sigma^2, beta, x) inference: LGC_RMHMC_Paras_LV.m /
            # LGC_mMALA_Paras_LV.m (HP eps 0.2; latent eps 0.1 / 0.07).
            from riemannhamiltonianmontecarlo.samplers import lgc_joint

            jm = lgc_model.LGCJointModel(jnp.asarray(y, jnp.float32), n=lgc_n)
            cfg_kw = (dict(method="mmala", latent_step_size=0.07)
                      if sampler == "mmala_joint" else {})
            kernel = lgc_joint.build(jm, lgc_joint.LGCJointConfig(**{**cfg_kw, **kw}))
            theta0 = jnp.asarray([jm.init_sigma_sq, jm.init_beta], jnp.float32)
            return (kernel, lambda c: jnp.tile(theta0, (c, 1)),
                    lambda st: (st.position, st.x),
                    lambda smp: {"hyper": smp[0], "latent": smp[1]}, None)

        model = lgc_model.LGCModel(jnp.asarray(y, jnp.float32), n=lgc_n)

        if sampler in ("mala_transient", "mala_stationary"):
            # Whitened parametrization, LGC_MALA_Transient.m:32-33 /
            # LGC_MALA_Stationary.m:32-33.
            wh = model.whitened()
            cfg = (s.mala.MALAConfig(step_size=2.0, transient=True, **kw)
                   if sampler == "mala_transient"
                   else s.mala.MALAConfig(step_size=1.65 ** 2, **kw))
            kernel = s.mala.build(wh, cfg)
            lift = jax.jit(jax.vmap(wh.to_x))
            return (kernel, lambda c: jnp.zeros((c, model.dim)), None,
                    lambda smp: {"latent": lift(smp)}, None)

        if sampler == "mmala":
            # LGC_mMALA_LV.m:31-34
            kernel = s.mmala.build(model, s.mmala.MMALAConfig(
                **{"step_size": 0.07, "jitter": 1e-5, **kw}))
        elif sampler == "rmhmc":
            # Constant-metric RMHMC == preconditioned HMC,
            # LGC_RMHMC_LV.m:95-101,149-196 (L=30, eps=0.1 :32-33).
            kernel = phmc.build(model, model.metric_chol, model.metric_inv,
                                phmc.PHMCConfig(**{"step_size": 0.1,
                                                   "num_leapfrog": 30, **kw}))
        else:
            raise KeyError(f"unknown lgc sampler '{sampler}'")
        prior = model.prior_mean()
        return (kernel, lambda c: jnp.tile(prior, (c, 1)), None,
                lambda smp: {"latent": smp}, None)

    if workload == "fhn":
        from riemannhamiltonianmontecarlo.models import fhn as fhn_model

        data, _ = fhn_model.generate_data(seed=seed if seed > 0 else 1, num_obs=fhn_obs)
        model = fhn_model.FHNModel(jnp.asarray(data, jnp.float32), substeps=fhn_substeps)
        builders = {
            # ODE_RMHMC.m:72-74
            "rmhmc": lambda: s.rmhmc.build(model, s.rmhmc.RMHMCConfig(
                **{"step_size": 0.5, "num_leapfrog": 6, "num_fixed_point": 5,
                   "jitter": 1e-6, **kw})),
            # ODE_HMC.m:68-69
            "hmc": lambda: s.hmc.build(model, s.hmc.HMCConfig(
                **{"step_size": 1.0 / 150.0, "num_leapfrog": 150, **kw})),
            # ODE_MALA.m:64
            "mala": lambda: s.mala.build(model, s.mala.MALAConfig(
                **{"step_size": 2e-4, **kw})),
            # ODE_mMALA.m:69
            "mmala": lambda: s.mmala.build(model, s.mmala.MMALAConfig(
                **{"step_size": 1.0, "jitter": 1e-6, **kw})),
            # ODE_mMALA_Simp.m:74
            "mmala_simplified": lambda: s.mmala.build(model, s.mmala.MMALAConfig(
                **{"step_size": 1.0, "simplified": True, "jitter": 1e-6, **kw})),
            "metropolis": lambda: s.metropolis.build(model, s.metropolis.AMHConfig(
                **{"init_proposal_sd": 0.05, **kw})),
        }
        kernel = builders[sampler]()
        theta0 = jnp.asarray([0.2, 0.2, 3.0], jnp.float32)

        def init_fn(chains: int):
            jitter = 1.0 + 0.05 * jax.random.normal(jax.random.key(seed + 11), (chains, 3))
            return jnp.tile(theta0, (chains, 1)) * jitter

        return kernel, init_fn, None, lambda smp: {"params": smp}, None

    raise KeyError(f"unknown workload '{workload}'; options: {tuple(WORKLOAD_SAMPLERS)}")


@dataclasses.dataclass
class WorkloadResult:
    workload: str
    sampler: str
    num_chains: int
    num_samples: int
    accept_rate: float
    divergences: int
    sampling_time_s: float
    ess: dict[str, np.ndarray]  # group -> per-coordinate chain-summed ESS
    rhat_max: dict[str, float] = dataclasses.field(default_factory=dict)
    geweke_max_abs_z: dict[str, float] = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        lines = [
            f"{self.workload}/{self.sampler}: {self.num_chains} chains x "
            f"{self.num_samples} samples   accept {self.accept_rate:.3f}   "
            f"divergences {self.divergences}   sampling {self.sampling_time_s:.3f} s"
        ]
        for group, ess in self.ess.items():
            rhat = self.rhat_max.get(group, float("nan"))
            gz = self.geweke_max_abs_z.get(group, float("nan"))
            lines.append(
                f"  {group}: ESS min {ess.min():.0f}  median {np.median(ess):.0f}  "
                f"max {ess.max():.0f}   time/minESS {self.sampling_time_s / ess.min():.3e} s"
                f"   max R-hat {rhat:.4f}   max |Geweke z| {gz:.2f}"
            )
        return "\n".join(lines)


def run_workload(workload: str, sampler: str, *, num_chains: int = 64,
                 num_samples: int = 1000, burn_in: int = 300, seed: int = 0,
                 overrides: dict[str, Any] | None = None, **data_kw) -> WorkloadResult:
    """Reference-preset experiment on any of the four workloads."""
    if workload == "blr":
        raise ValueError("use run_experiment(...) for the BLR workload")
    kernel, init_fn, collect_fn, groups_fn, warmup_kernel = build_workload(
        workload, sampler, overrides=overrides, seed=seed, **data_kw)
    samples, accept, div, t = timed_sampling(
        kernel, init_fn(num_chains), burn_in=burn_in, num_samples=num_samples,
        seed=seed, collect_fn=collect_fn, warmup_kernel=warmup_kernel)
    groups = groups_fn(samples)
    ess = {g: np.asarray(diagnostics.ess_geyer_device(a)) for g, a in groups.items()}
    rhat = ({g: float(jnp.max(diagnostics.split_rhat_device(a))) for g, a in groups.items()}
            if num_chains >= 2 else {})
    # Geweke stationarity per group on a small chain subset (bounded
    # host transfer; z ~ N(0,1) under stationarity).
    geweke = {g: float(np.abs(diagnostics.geweke_z(np.asarray(a[:8]))).max())
              for g, a in groups.items()}
    num_kept = int(jax.tree.leaves(samples)[0].shape[1])
    return WorkloadResult(workload, sampler, num_chains, num_kept, accept, div, t, ess,
                          rhat, geweke)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", choices=tuple(WORKLOAD_SAMPLERS), default="blr")
    ap.add_argument("--sampler", default="rmhmc")
    ap.add_argument("--dataset", default="australian")
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--burn-in", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", choices=("map", "zeros", "reference"), default="map")
    ap.add_argument("--ess-mode", choices=("reference", "exact", "device", "native"),
                    default="reference",
                    help="'native' routes the Geyer estimator through the "
                         "threaded C++ engine (native/fastess.cpp) -- the "
                         "host-side path for C*P >> 1e4 series")
    ap.add_argument("--adapt", action="store_true",
                    help="dual-averaging step-size warmup instead of the "
                         "hand-tuned reference constant (BLR only)")
    args = ap.parse_args(argv)
    utils.enable_compile_cache()
    if args.sampler not in WORKLOAD_SAMPLERS[args.workload]:
        ap.error(f"sampler '{args.sampler}' not available for workload "
                 f"'{args.workload}' (options: {WORKLOAD_SAMPLERS[args.workload]})")
    if args.workload == "blr":
        res = run_experiment(
            args.sampler,
            args.dataset,
            num_chains=args.chains or 1024,
            num_samples=args.samples,
            burn_in=args.burn_in,
            seed=args.seed,
            init=args.init,
            ess_mode=args.ess_mode,
            adapt=args.adapt,
        )
        if args.adapt:
            print(f"adapted step size: {res.adapted_step_size:.4g}")
    else:
        res = run_workload(
            args.workload,
            args.sampler,
            num_chains=args.chains or 64,
            num_samples=args.samples or 1000,
            burn_in=args.burn_in if args.burn_in is not None else 300,
            seed=args.seed,
        )
    print(res.summary())


if __name__ == "__main__":
    main()

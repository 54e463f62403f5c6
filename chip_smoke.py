"""Smoke test of the sampling library on NVIDIA GPUs.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: the sharded paths only

One card:

* device  -- JAX's default device is a GPU; prints the card and setup;
* blr     -- RMHMC on Bayesian logistic regression through
  ``experiments.run_experiment`` at the reference constants (eps=0.5,
  L=6, 4 fixed-point steps), 4096 chains, seeded data at australian's
  published shape (N=690, D=15 with the intercept), checked for
  acceptance, divergences, split R-hat, ESS and the posterior mean of an
  HMC run on the same data;
* precision -- the card's float32 ``manifold_state`` (logp, grad, G)
  against a float64 NumPy implementation at 64 positions, at a tolerance
  TF32 matmuls would miss;
* lgc     -- constant-metric RMHMC on the log-Gaussian Cox model at
  n=64 (D=4096), L=30, eps=0.1, 256 chains;
* linalg  -- the small-matrix factor / solve / log-det that ``ops.linalg``
  picks on the GPU at 4096 chains and D in {8, 15, 25}, against NumPy
  float64, and proof that the Pallas kernel was compiled for the card.

Four cards (``--multi``): chain-sharded BLR RMHMC against the same keys on
one card, and the LGC model on a 2 x 2 ("chains", "latent") mesh against
the unsharded model.

Every check raises on failure.  The last line of standard output is one
JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from riemannhamiltonianmontecarlo import experiments, models, ops, parallel, utils  # noqa: E402
from riemannhamiltonianmontecarlo.models import lgc  # noqa: E402
from riemannhamiltonianmontecarlo.samplers import phmc, rmhmc  # noqa: E402

SEED = 0
# Weight scale of the seeded data: logits have a standard deviation of
# about 0.5 * sqrt(15) ~ 1.9, so classes overlap as in australian credit
# and the posterior is proper and well identified.
W_SCALE = 0.5
BLR_CHAINS = 4096
LGC_CHAINS = 256


def check_device(count: int) -> dict:
    """Raise unless JAX sees at least ``count`` GPUs; return the device record."""
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        raise RuntimeError(
            f"needs {count} GPU(s); JAX found {len(devices)} x {devices[0].platform}"
        )
    return utils.device_record()


def blr_data() -> models.Dataset:
    return models.synthetic_logreg(seed=SEED, n=690, d=15, w_scale=W_SCALE)


def blr_model(ds: models.Dataset) -> models.LogisticRegression:
    return models.LogisticRegression(jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32))


def numpy_manifold_state(x, t, w, alpha: float = 100.0):
    """float64 logp, grad and Fisher metric of Bayesian logistic regression
    (``models/logreg.py`` docstring; reference ``code/rmhmc.py:50-57``)."""
    x, t, w = (np.asarray(a, np.float64) for a in (x, t, w))
    d = x.shape[1]
    f = w @ x.T
    logp = (f @ t - np.logaddexp(0.0, f).sum(-1)
            - 0.5 * d * np.log(2.0 * np.pi * alpha) - 0.5 * (w * w).sum(-1) / alpha)
    p = 1.0 / (1.0 + np.exp(-f))
    grad = (t - p) @ x - w / alpha
    metric = np.einsum("cn,na,nb->cab", p * (1.0 - p), x, x) + np.eye(d) / alpha
    return logp, grad, metric


def max_rel_err(got, ref) -> float:
    """Largest per-chain normwise relative error: max|got - ref| / max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    axes = tuple(range(1, ref.ndim))
    err = np.abs(got - ref).max(axis=axes) if axes else np.abs(got - ref)
    scale = np.abs(ref).max(axis=axes) if axes else np.abs(ref)
    return float((err / scale).max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_device(count: int) -> tuple[dict, str]:
    device = check_device(count)
    card = utils.gpu_name_and_power_limit()
    print(f"card: {card}")
    print(f"device: {device}  jax {jax.__version__}  compile cache: "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)
    return device, card


def phase_blr(card: str, chains: int = BLR_CHAINS, steps: int = 200) -> None:
    ds = blr_data()
    common = dict(num_chains=chains, num_samples=steps, burn_in=steps, seed=SEED)
    t0 = time.perf_counter()
    res = experiments.run_experiment("rmhmc", ds, **common)
    print(res.summary())
    print(f"blr rmhmc wall clock incl. compile {time.perf_counter() - t0:.1f} s")
    ref = experiments.run_experiment("hmc", ds, **common)
    print(ref.summary(), flush=True)

    transitions = chains * res.num_samples
    require(0.75 <= res.accept_rate <= 0.99, f"acceptance {res.accept_rate}")
    require(res.divergences <= 1e-3 * transitions, f"{res.divergences} divergences")
    require(res.rhat_max < 1.05, f"max split R-hat {res.rhat_max}")
    require(np.isfinite(res.ess_max) and res.ess_min > 0, f"ESS {res.ess_min}..{res.ess_max}")
    gap = float(np.abs(res.posterior_mean - ref.posterior_mean).max())
    require(gap < 0.05, f"RMHMC vs HMC posterior mean differ by {gap}")
    print(f"blr: min-ESS/s {res.ess_min / res.sampling_time_s:.1f} "
          f"({chains} chains, {res.sampling_time_s:.3f} s sampling) on {card}; "
          f"posterior mean gap to HMC {gap:.4f}")
    print("PASS blr", flush=True)


def phase_precision(chains: int = 64) -> None:
    ds = blr_data()
    model = blr_model(ds)
    w = utils.default_init(model, jax.random.key(SEED), chains)
    ms = jax.jit(model.manifold_state)(w)
    logp, grad, metric = numpy_manifold_state(ds.X, ds.t, w)
    errs = {"logp": max_rel_err(ms.logp, logp), "grad": max_rel_err(ms.grad, grad),
            "metric": max_rel_err(ms.metric, metric)}
    # The same gradient at DEFAULT precision shows what a TF32 contraction
    # would look like (on the CPU DEFAULT is full f32).
    resid = model.t - jax.nn.sigmoid(jnp.matmul(w, model.X.T, precision=jax.lax.Precision.HIGHEST))
    fast = jnp.matmul(resid, model.X, precision=jax.lax.Precision.DEFAULT) - w / model.alpha
    print(f"precision: max normwise rel err {errs}; DEFAULT-precision grad "
          f"{max_rel_err(fast, grad):.2e}")
    for name, err in errs.items():
        require(err < 1e-4, f"{name} rel err {err} (TF32 contraction?)")
    print("PASS precision", flush=True)


def phase_lgc(chains: int = LGC_CHAINS, n: int = 64) -> None:
    kernel, init_fn, _, _, _ = experiments.build_workload("lgc", "rmhmc", seed=SEED, lgc_n=n)
    res = parallel.run(kernel, jax.random.key(SEED), init_fn(chains), num_samples=20,
                       burn_in=20, collect=False)
    pos = np.asarray(res.final_state.position)
    print(f"lgc D={n * n}: accept {float(res.accept_rate):.3f} "
          f"(burn-in {float(res.warmup_accept_rate):.3f}), divergences {int(res.divergences)}")
    require(np.isfinite(pos).all(), "non-finite LGC positions")
    require(float(res.accept_rate) > 0.5, f"LGC acceptance {float(res.accept_rate)}")
    print("PASS lgc", flush=True)


def phase_linalg(chains: int = 4096, dims=(8, 15, 25)) -> None:
    rng = np.random.default_rng(SEED)
    for d in dims:
        a = rng.normal(size=(chains, d, d))
        g64 = a @ np.swapaxes(a, -1, -2) + d * np.eye(d)
        b64 = rng.normal(size=(chains, d))
        g, b = jnp.asarray(g64, jnp.float32), jnp.asarray(b64, jnp.float32)

        def bundle(g, b):
            l = ops.cholesky(g)
            return l, ops.solve_psd(g, b), ops.logdet_from_chol(l)

        fn = jax.jit(bundle)
        hlo = fn.lower(g, b).compile().as_text()
        kernels = hlo.count("__gpu$xla.gpu.triton")
        l, x, logdet = fn(g, b)
        np.testing.assert_allclose(np.asarray(l), np.linalg.cholesky(g64), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(g64, b64[..., None])[..., 0],
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(np.asarray(logdet), np.linalg.slogdet(g64)[1],
                                   rtol=2e-4, atol=2e-3)
        expect = ops.linalg.uses_kernel(d)
        require((kernels > 0) == expect,
                f"D={d}: {kernels} compiled Triton calls, kernel expected: {expect}")
        print(f"linalg D={d}: {'Pallas Triton kernel' if expect else 'XLA path'} "
              f"({kernels} Triton custom calls in the compiled program) matches NumPy float64")
    print("PASS linalg", flush=True)


def _spans(arr, devices) -> None:
    got = arr.sharding.device_set
    require(got == set(devices), f"array spans {len(got)} devices, expected {len(devices)}")


def phase_multi_blr(devices, chains: int = BLR_CHAINS, transitions: int = 3) -> None:
    model = blr_model(blr_data())
    kernel = rmhmc.build(model)
    init = utils.default_init(model, jax.random.key(SEED), chains)
    key = jax.random.key(SEED + 1)
    one = parallel.run(kernel, key, init, num_samples=transitions, collect=False)
    mesh = parallel.make_mesh(len(devices))
    sharded = parallel.run(kernel, key, init, num_samples=transitions, collect=False, mesh=mesh)
    pos = sharded.final_state.position
    _spans(pos, devices)
    np.testing.assert_allclose(np.asarray(pos), np.asarray(one.final_state.position),
                               rtol=1e-4, atol=1e-4)
    gap = abs(float(sharded.accept_rate) - float(one.accept_rate))
    require(gap < 1e-3, f"acceptance differs by {gap}")
    print(f"multi blr: {chains} chains over {len(devices)} devices match one device; "
          f"accept {float(sharded.accept_rate):.4f}")
    print("PASS multi_blr", flush=True)


def phase_multi_lgc(devices, chains: int = 32, n: int = 64, transitions: int = 3) -> None:
    y, _ = lgc.generate_data(seed=SEED, n=n)
    model = lgc.LGCModel(jnp.asarray(y, jnp.float32), n=n)
    cfg = phmc.PHMCConfig(step_size=0.1, num_leapfrog=30)
    init = jnp.tile(model.prior_mean(), (chains, 1))
    key = jax.random.key(SEED + 2)
    plain = parallel.run(phmc.build(model, model.metric_chol, model.metric_inv, cfg), key,
                         init, num_samples=transitions, collect=False)

    mesh = Mesh(np.asarray(devices).reshape(2, 2), ("chains", "latent"))
    sm = model.with_sharding(mesh)
    init_s = jax.device_put(init, NamedSharding(mesh, P("chains", "latent")))
    res = parallel.run(phmc.build(sm, sm.metric_chol, sm.metric_inv, cfg), key, init_s,
                       num_samples=transitions, collect=False)
    _spans(sm.metric_inv, devices)
    _spans(res.final_state.position, devices)
    np.testing.assert_allclose(np.asarray(res.final_state.position),
                               np.asarray(plain.final_state.position), rtol=1e-3, atol=1e-3)
    print(f"multi lgc D={n * n}: mesh {dict(mesh.shape)} matches unsharded; "
          f"accept {float(res.accept_rate):.3f}")
    print("PASS multi_lgc", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card sharded phases instead of the one-card phases")
    args = ap.parse_args(argv)
    utils.enable_compile_cache()
    jax.config.update("jax_threefry_partitionable", True)

    t0 = time.perf_counter()
    if args.multi:
        device, _ = phase_device(4)
        devices = jax.devices()[:4]
        phase_multi_blr(devices)
        phase_multi_lgc(devices)
    else:
        device, card = phase_device(1)
        phase_blr(card)
        phase_precision()
        phase_lgc()
        phase_linalg()
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()

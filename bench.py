"""Headline benchmark: min-ESS/s, Bayesian logistic regression, RMHMC.

Prints ONE JSON line as the last line of its output:
    {"metric": "...", "value": N, "unit": "ESS/s", "device": {...}, ...}

Protocol:
* workload: seeded data at australian credit's published shape (N=690,
  D=15 with the intercept; ``models.synthetic_logreg(seed=0, n=690, d=15,
  w_scale=0.5)``), RMHMC at the reference constants (eps=0.5, L=6, 4
  fixed-point steps);
* value: total ESS (minimum over the 15 coordinates, summed over chains,
  Geyer initial-monotone estimator in reference mode) divided by the
  wall-clock of the *sampling phase only* (the reference times the same
  way, ``code/rmhmc.py:194-198``);
* also a short LGC D=4096 constant-metric RMHMC run, reported as seconds
  per transition.

Run on a GPU: ``python bench.py``.  The card's name and power limit are
printed before the JSON line.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

NUM_CHAINS = 4096
BURN_IN = 300
NUM_SAMPLES = 1000
DATA_SEED = 0
W_SCALE = 0.5  # logit std ~1.9 over 15 standardized features


def _measure_at(kernel, model, num_chains: int):
    """Full headline protocol at one chain count: burn-in, compile-warm
    pass, then the timed sampling phase.  Returns (value, elapsed, min_ess).
    """
    import jax

    import riemannhamiltonianmontecarlo as rhmc

    init = rhmc.utils.default_init(model, jax.random.key(7), num_chains)
    # Burn-in + compile of the exact timed computation (same shapes/flags),
    # so the timed pass below hits the jit cache.
    warm = rhmc.parallel.run(
        kernel, jax.random.key(1), init, num_samples=BURN_IN, burn_in=0, collect=False
    )
    jax.block_until_ready(warm.final_state.position)
    pre = rhmc.parallel.run(
        kernel, jax.random.key(2), None,
        num_samples=NUM_SAMPLES, burn_in=0, init_state=warm.final_state,
    )
    jax.block_until_ready(pre.samples)

    # Timed sampling phase; the timer stops at device completion.
    t0 = time.perf_counter()
    res = rhmc.parallel.run(
        kernel, jax.random.key(3), None,
        num_samples=NUM_SAMPLES, burn_in=0, init_state=pre.final_state,
    )
    jax.block_until_ready(res.samples)
    elapsed = time.perf_counter() - t0

    samples = np.asarray(res.samples)
    ess = rhmc.diagnostics.ess_multichain(samples)  # (D,) summed over chains
    return float(ess.min()) / elapsed, elapsed, float(ess.min())


def lgc_seconds_per_transition():
    """Short LGC D=4096 constant-metric RMHMC run (L=30, eps=0.1)."""
    import jax
    import jax.numpy as jnp

    import riemannhamiltonianmontecarlo as rhmc
    from riemannhamiltonianmontecarlo.models import lgc
    from riemannhamiltonianmontecarlo.samplers import phmc

    chains, steps, leap = 256, 200, 30
    y, _ = lgc.generate_data(seed=DATA_SEED, n=64)
    model = lgc.LGCModel(jnp.asarray(y, jnp.float32), n=64)
    kernel = phmc.build(model, model.metric_chol, model.metric_inv,
                        phmc.PHMCConfig(step_size=0.1, num_leapfrog=leap))
    init = jnp.tile(model.prior_mean(), (chains, 1))
    warm = rhmc.parallel.run(kernel, jax.random.key(1), init,
                             num_samples=steps, collect=False)
    jax.block_until_ready(warm.final_state.position)
    t0 = time.perf_counter()
    res = rhmc.parallel.run(kernel, jax.random.key(2), None, num_samples=steps,
                            collect=False, init_state=warm.final_state)
    jax.block_until_ready(res.final_state.position)
    elapsed = time.perf_counter() - t0
    return {
        "seconds_per_transition": elapsed / steps,
        "accept_rate": float(res.accept_rate),
        "note": f"{chains} chains x {steps} steps, L={leap}, D={model.dim}",
    }


def main() -> None:
    import jax.numpy as jnp

    import riemannhamiltonianmontecarlo as rhmc

    rhmc.utils.enable_compile_cache()
    device = rhmc.utils.device_record()
    if device["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {device}")
    card = rhmc.utils.gpu_name_and_power_limit()
    print(card, flush=True)

    ds = rhmc.models.synthetic_logreg(seed=DATA_SEED, n=690, d=15, w_scale=W_SCALE)
    model = rhmc.models.LogisticRegression(
        jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32)
    )
    kernel = rhmc.samplers.rmhmc.build(model)  # reference constants

    sweep = []
    best = None
    for c in (NUM_CHAINS, 2 * NUM_CHAINS):
        value, elapsed, min_ess = _measure_at(kernel, model, c)
        sweep.append({"chains": c, "min_ess_per_s": value,
                      "sampling_s": elapsed, "min_ess": min_ess})
        if best is None or value > best[0]:
            best = (value, c)
    value, best_chains = best

    record = {
        "metric": f"BLR australian-shape RMHMC min-ESS/s ({best_chains} chains, 1 card)",
        "value": value,
        "unit": "ESS/s",
        "device": device,
        "card": card,
        "chain_sweep": sweep,
        "lgc_d4096": lgc_seconds_per_transition(),
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()

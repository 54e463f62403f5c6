"""Time the small-matrix linalg candidates on the GPU.

For each linalg method ("pallas": the Triton kernel, "unrolled": the
unrolled XLA graph, "xla": cuSOLVER potrf + triangular_solve) this times
the full RMHMC transition at australian's shape (N=690, D=15, seeded
data), 4096 chains, reference constants (eps=0.5, L=6, 4 fixed-point
steps), as sampling seconds per transition.  Methods run in the order
A B C C B A so drift shows up as asymmetry.

    python tools/time_linalg.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import riemannhamiltonianmontecarlo as rhmc  # noqa: E402

METHODS = ("pallas", "unrolled", "xla")
CHAINS = 4096


def rmhmc_step(steps=50):
    ds = rhmc.models.synthetic_logreg(seed=0, n=690, d=15, w_scale=0.5)
    model = rhmc.models.LogisticRegression(jnp.asarray(ds.X, jnp.float32),
                                           jnp.asarray(ds.t, jnp.float32))
    init = rhmc.utils.default_init(model, jax.random.key(0), CHAINS)
    kernels = {m: rhmc.samplers.rmhmc.build(model, rhmc.samplers.rmhmc.RMHMCConfig(linalg=m))
               for m in METHODS}
    states = {}
    for m, k in kernels.items():
        t0 = time.perf_counter()
        r = rhmc.parallel.run(k, jax.random.key(1), init, num_samples=steps, collect=False)
        jax.block_until_ready(r.final_state.position)
        states[m] = r.final_state
        print(f"rmhmc {m}: first run (compile + {steps} steps) {time.perf_counter() - t0:.1f} s, "
              f"accept {float(r.accept_rate):.3f}", flush=True)
    times = {m: [] for m in METHODS}
    for m in METHODS + METHODS[::-1]:
        t0 = time.perf_counter()
        r = rhmc.parallel.run(kernels[m], jax.random.key(2), None, num_samples=steps,
                              collect=False, init_state=states[m])
        jax.block_until_ready(r.final_state.position)
        times[m].append((time.perf_counter() - t0) / steps)
    print("rmhmc australian-shape 4096 chains, ms per transition: "
          + ", ".join(f"{m}={[round(t * 1e3, 3) for t in v]}" for m, v in times.items()),
          flush=True)


if __name__ == "__main__":
    rhmc.utils.enable_compile_cache()
    print(rhmc.utils.device_record(), jax.__version__)
    print(rhmc.utils.gpu_name_and_power_limit(), flush=True)
    rmhmc_step()

"""Multi-process worker: one rank of a cross-host chain-parallel run.

Spawned by ``tests/test_distributed.py`` with N>=1 processes x 4 virtual
CPU devices each, coordinated through ``jax.distributed.initialize`` (the
real multi-host bring-up path, ``parallel.mesh.initialize_distributed``).
Runs chain-parallel HMC on the australian BLR posterior with the global
chain axis sharded across *processes*, reduces acceptance statistics and
split-R-hat across the whole mesh (GSPMD psum under jit + one explicit
``shard_map`` psum), and writes per-process checkpoint shards.

The single-process invocation of this same script is the parity oracle:
with partitionable threefry the global computation is device-layout
independent, so posterior mean / R-hat / acceptance must agree across
process counts (SURVEY.md section 2.4 comm row; BASELINE.json "linear
chain scaling to 2+ hosts" contract).
"""

import argparse
import json
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from jax.experimental.shard_map import shard_map

CHAINS = 32
SAMPLES = 200
BURN = 100


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args()

    from riemannhamiltonianmontecarlo import diagnostics, models, parallel, samplers, utils
    from riemannhamiltonianmontecarlo.parallel.mesh import initialize_distributed

    if args.num_processes > 1:
        initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    assert jax.process_count() == args.num_processes

    mesh = Mesh(np.array(jax.devices()), ("chains",))
    sharding = NamedSharding(mesh, PartitionSpec("chains", None))

    ds = models.load_dataset("australian")
    model = models.LogisticRegression(
        jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32)
    )
    kernel = samplers.hmc.build(model, samplers.hmc.HMCConfig(step_size=0.1, num_leapfrog=10))

    # Identical global init in every process; each rank materializes only
    # its addressable shards.
    init_np = np.asarray(
        utils.default_init(model, jax.random.key(1), CHAINS), np.float32
    )
    init = jax.make_array_from_callback((CHAINS, model.dim), sharding,
                                        lambda idx: init_np[idx])
    state = jax.jit(kernel.init)(init)

    res = parallel.run(kernel, jax.random.key(2), None, num_samples=SAMPLES,
                       burn_in=BURN, init_state=state)

    # Cross-process reductions under GSPMD (lower to psum over the mesh).
    post_mean = jax.jit(lambda s: jnp.mean(s, axis=(0, 1)))(res.samples)
    rhat = jax.jit(diagnostics.split_rhat_device)(res.samples)

    # Explicit psum spelling: pooled per-chain acceptance via shard_map.
    per_chain_mean = jax.jit(lambda s: jnp.mean(s, axis=1))(res.samples)  # (C, D)
    pooled = jax.jit(
        shard_map(
            lambda x: jax.lax.pmean(jnp.mean(x, axis=0), "chains"),
            mesh=mesh,
            in_specs=PartitionSpec("chains", None),
            out_specs=PartitionSpec(),
        )
    )(per_chain_mean)

    # Per-process checkpoint shards of the final sharded state.
    out_dir = Path(args.out_dir)
    ckpt = out_dir / "ckpt.npz"
    utils.checkpoint.save_state(ckpt, res.final_state, step=SAMPLES)
    # Round-trip the local shard against the live state.
    local_template = jax.tree.map(
        lambda leaf: np.zeros(
            (leaf.shape[0] // args.num_processes, *leaf.shape[1:]), leaf.dtype
        )
        if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] == CHAINS
        else np.asarray(leaf),
        res.final_state,
    )
    restored, step, _ = utils.checkpoint.load_state(ckpt, local_template)
    lo = args.process_id * (CHAINS // args.num_processes)
    hi = lo + CHAINS // args.num_processes
    pos_local = np.concatenate(
        [
            np.asarray(s.data)
            for s in sorted(
                res.final_state.position.addressable_shards,
                key=lambda s: s.index[0].start or 0,
            )
        ],
        axis=0,
    )
    ckpt_ok = bool(np.array_equal(np.asarray(restored.position), pos_local)) and step == SAMPLES

    out = {
        "process_id": args.process_id,
        "num_processes": args.num_processes,
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
        "posterior_mean": np.asarray(post_mean).tolist(),
        "rhat": np.asarray(rhat).tolist(),
        "pooled_mean": np.asarray(pooled).tolist(),
        "accept": float(res.accept_rate),
        "ckpt_roundtrip_ok": ckpt_ok,
    }
    (out_dir / f"out.p{args.process_id}.json").write_text(json.dumps(out))
    print(f"worker {args.process_id}/{args.num_processes} done", flush=True)


if __name__ == "__main__":
    main()

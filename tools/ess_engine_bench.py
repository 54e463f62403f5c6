"""Native C++ ESS engine vs NumPy on a real results-scale sample tensor.

Usage: PYTHONPATH=. python tools/ess_engine_bench.py [--dataset german]
       [--chains 2048]

Runs the real BLR RMHMC experiment through ``--ess-mode native`` (the
CLI route, ``experiments.py``), then times the threaded C++ Geyer engine
(``native/fastess.cpp``) against the NumPy path on the same (C, S, D)
tensor, checks parity, and prints a markdown table.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="german")
    ap.add_argument("--chains", type=int, default=2048)
    args = ap.parse_args()

    from riemannhamiltonianmontecarlo import diagnostics
    from riemannhamiltonianmontecarlo.experiments import run_experiment

    print(f"--- BLR {args.dataset} rmhmc, ess_mode=native "
          f"({args.chains} chains)", flush=True)
    res = run_experiment("rmhmc", args.dataset, num_chains=args.chains,
                         ess_mode="native", keep_samples=True,
                         max_steps_per_call=1250)
    print(res.summary(), flush=True)
    samples = res.samples  # (C, S, D) host array
    c, s, d = samples.shape

    t0 = time.perf_counter()
    ess_native = diagnostics.ess_geyer_native(samples)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    # "exact" (alias-free) mode: the estimator the native engine implements.
    ess_numpy = diagnostics.ess_multichain(samples, nfft_mode="exact")
    t_numpy = time.perf_counter() - t0
    rel = np.abs(ess_native - ess_numpy) / ess_numpy
    print(f"native {t_native:.2f}s vs numpy {t_numpy:.2f}s "
          f"({t_numpy / t_native:.1f}x); max rel dev {rel.max():.2e}",
          flush=True)
    assert rel.max() < 1e-3, rel.max()

    section = (
        f"## Native ESS engine -- BLR {args.dataset} RMHMC, "
        f"{c} chains x {s} samples x {d} coords\n\n"
        "A full-protocol run measured end-to-end through `--ess-mode "
        "native`\n(`experiments.py` CLI -> `native/fastess.cpp`, threaded "
        "FFT Geyer; its own\nrun stats below -- the BLR table row is an "
        "independent measurement).\n"
        f"Post-processing the same ({c}, {s}, {d}) tensor "
        f"({c * d:,} series):\n\n"
        "| engine | wall (s) | speedup | max rel. deviation |\n"
        "|---|---|---|---|\n"
        f"| NumPy (reference mode) | {t_numpy:.2f} | 1x | -- |\n"
        f"| C++ threaded (`fastess`) | {t_native:.2f} "
        f"| {t_numpy / t_native:.1f}x | {rel.max():.1e} |\n\n"
        f"Experiment row: min ESS {res.ess_min:,.0f}, "
        f"sampling {res.sampling_time_s:.2f} s, "
        f"s/minESS {res.time_per_min_ess:.2e}, accept {res.accept_rate:.3f}, "
        f"max R-hat {res.rhat_max:.4f}."
    )
    print(section, flush=True)


if __name__ == "__main__":
    main()

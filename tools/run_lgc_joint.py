"""Run the joint (sigma^2, beta, x) LGC samplers at the reference 64x64 size.

The paper's most expensive configuration (main_article.pdf sec. 8: "5000
posterior samples taking around 90 h of computation time";
``LGC_RMHMC_Paras_LV.m:41-47``, mMALA variant ``LGC_mMALA_Paras_LV.m:42-43``).
No per-method ESS table exists for it, so the headline comparison is
wall-clock per posterior sample vs the paper's ~64.8 s (324000 s / 5000),
alongside our measured hyper/latent ESS and s/minESS.

Usage::

    PYTHONPATH=. python tools/run_lgc_joint.py --method rmhmc --chains 4 \
        --samples 5000 --burn-in 1000 [--calibrate]

Protocol: authors' data (``TestData64.mat``) when present, segmented
device calls with on-disk state checkpoints (an interrupted run resumes,
not restarts), and steady-state timing = mean per-segment wall-clock over all sampling
segments after the first (which pays XLA compilation) times the segment
count.  Results are spliced into RESULTS.md section ``lgc-joint``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from riemannhamiltonianmontecarlo import parallel
from riemannhamiltonianmontecarlo.diagnostics.ess import ess_geyer_device
from riemannhamiltonianmontecarlo.models import lgc
from riemannhamiltonianmontecarlo.samplers import lgc_joint

RESULTS = Path(__file__).resolve().parents[1] / "RESULTS.md"
PAPER_SECONDS_PER_SAMPLE = 324000.0 / 5000.0  # ~90 h / 5000 samples

HEADER = ("| sampler | chains | samples | accept | divergent | block | total ESS "
          "(min, med, max) | s/minESS | wall (s) | s/sample | paper s/sample "
          "| speedup |\n|---|---|---|---|---|---|---|---|---|---|---|---|")


def _collect_theta_x(st):
    """Module-level so the jitted scan's static collect_fn hashes equal
    across segments -- an inline lambda forced a full XLA recompile of the
    D=4096 program on EVERY collecting segment (~170 s each in round 4)."""
    return (st.position, st.x)


def run_segmented(kernel, init, *, burn_in, num_samples, seg, seed, ckpt_dir,
                  tag):
    """Segmented run with disk checkpoints; returns (theta, x, accept, time).

    Timing: per-segment wall clocks are recorded; the steady-state
    sampling time is mean(segment times after the first) * n_segments.
    """
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    meta_f = ckpt_dir / f"{tag}.meta.json"
    state_f = ckpt_dir / f"{tag}.state.npz"

    key = jax.random.key(seed)
    total = burn_in + num_samples
    n_seg = -(-total // seg)

    start_seg, state, seg_times = 0, None, []
    theta_parts, x_parts, acc, divs = [], [], [], []
    if meta_f.exists():
        meta = json.loads(meta_f.read_text())
        start_seg = meta["next_seg"]
        seg_times = meta["seg_times"]
        acc = meta["acc"]
        divs = meta.get("divs", [])
        with np.load(state_f) as d:
            flat = [jnp.asarray(d[f"leaf_{i}"]) for i in range(d["n_leaves"])]
        probe = kernel.init(init)
        state = jax.tree.unflatten(jax.tree.structure(probe), flat)
        for i in range(start_seg):
            f = ckpt_dir / f"{tag}.seg{i}.npz"
            if f.exists():
                with np.load(f) as d:
                    theta_parts.append(d["theta"])
                    x_parts.append(d["x"])
        print(f"[{tag}] resumed at segment {start_seg}/{n_seg}", flush=True)

    for i in range(start_seg, n_seg):
        lo, hi = i * seg, min((i + 1) * seg, total)
        n = hi - lo
        collecting = hi > burn_in
        t0 = time.perf_counter()
        r = parallel.run(
            kernel, jax.random.fold_in(key, i),
            init if state is None else None,
            num_samples=n, collect=collecting,
            init_state=state,
            collect_fn=_collect_theta_x if collecting else None,
        )
        state = r.final_state
        jax.block_until_ready(jax.tree.leaves(state)[0])
        dt = time.perf_counter() - t0
        if collecting:
            keep = max(burn_in - lo, 0)  # drop any burn-in inside the segment
            theta_np = np.asarray(r.samples[0][:, keep:])
            x_np = np.asarray(r.samples[1][:, keep:])
            theta_parts.append(theta_np)
            x_parts.append(x_np)
            np.savez(ckpt_dir / f"{tag}.seg{i}.npz", theta=theta_np, x=x_np)
            seg_times.append(dt)
            acc.append(float(r.accept_rate) * n)
            divs.append(int(r.divergences))
        flat = jax.tree.leaves(state)
        np.savez(state_f, n_leaves=len(flat),
                 **{f"leaf_{j}": np.asarray(leaf) for j, leaf in enumerate(flat)})
        meta_f.write_text(json.dumps(
            {"next_seg": i + 1, "seg_times": seg_times, "acc": acc,
             "divs": divs}))
        done = sum(p.shape[1] for p in theta_parts)
        print(f"[{tag}] seg {i + 1}/{n_seg}  {dt:.1f}s  "
              f"accept={float(r.accept_rate):.3f}  kept={done}/{num_samples}",
              flush=True)

    theta = np.concatenate(theta_parts, axis=1)
    x = np.concatenate(x_parts, axis=1)
    # Steady state: median segment time (robust to the first segment's
    # XLA compilation and to recompile spikes after a crash-resume).
    steady = float(np.median(seg_times[1:])) if len(seg_times) > 1 else seg_times[0]
    t_sampling = steady * len(seg_times)
    accept = sum(acc) / max(theta.shape[1], 1)
    return theta, x, accept, sum(divs), t_sampling


def fmt(v: float) -> str:
    return f"{v:.3g}" if abs(v) < 1000 else f"{v:,.0f}"


def ess_stats(samples_np) -> tuple[float, float, float]:
    ess = np.asarray(ess_geyer_device(jnp.asarray(samples_np)))
    return float(ess.min()), float(np.median(ess)), float(ess.max())


def splice(text: str, name: str, section: str) -> str:
    start, end = f"<!-- section:{name} -->", f"<!-- end:{name} -->"
    block = f"{start}\n{section}\n{end}"
    if start in text:
        return text[: text.index(start)] + block + text[text.index(end) + len(end):]
    return text.rstrip() + "\n\n" + block + "\n"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=("rmhmc", "mmala", "both"), default="both")
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--samples", type=int, default=5000)
    ap.add_argument("--burn-in", type=int, default=1000)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seg", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="/tmp/lgc_joint_ckpt")
    ap.add_argument("--calibrate", action="store_true",
                    help="time a few steps and exit (no RESULTS splice)")
    ap.add_argument("--no-splice", action="store_true")
    args = ap.parse_args()

    y, x_true = lgc.load_data(n=args.n) if args.n == 64 else lgc.generate_data(
        seed=7, n=args.n)
    data_src = ("authors' TestData64.mat (LGC_RMHMC_Paras_LV.m:12)"
                if args.n == 64 and lgc.REFERENCE_MAT.exists() else
                f"synthetic {args.n}x{args.n} draw")
    model = lgc.LGCJointModel(jnp.asarray(y, jnp.float32), n=args.n)
    init = jnp.tile(jnp.asarray([model.init_sigma_sq, model.init_beta],
                                jnp.float32), (args.chains, 1))

    methods = ("rmhmc", "mmala") if args.method == "both" else (args.method,)
    rows, sanity = [], []
    for method in methods:
        cfg = (lgc_joint.LGCJointConfig(method="mmala", latent_step_size=0.07)
               if method == "mmala" else lgc_joint.LGCJointConfig())
        kernel = lgc_joint.build(model, cfg)

        if args.calibrate:
            # Both passes use the SAME num_samples: _scan_phase jits on the
            # static step count, so a different count in the timed pass
            # would measure a fresh XLA compile (~2 min at D=4096), not the
            # step (the round-3 "30 s/step" artifact).
            t0 = time.perf_counter()
            r = parallel.run(kernel, jax.random.key(0), init, num_samples=4,
                             collect=False)
            jax.block_until_ready(jax.tree.leaves(r.final_state)[0])
            t_compile = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = parallel.run(kernel, jax.random.key(1), None, num_samples=4,
                             collect=False, init_state=r.final_state)
            jax.block_until_ready(jax.tree.leaves(r.final_state)[0])
            dt = (time.perf_counter() - t0) / 4
            theta_f = np.asarray(r.final_state.theta)
            print(f"[calibrate {method}] compile+4 steps {t_compile:.1f}s, "
                  f"steady {dt:.2f} s/step ({args.chains} chains), "
                  f"accept={float(r.accept_rate):.3f}, "
                  f"finite={np.isfinite(theta_f).all()}, "
                  f"theta={theta_f[0]}", flush=True)
            continue

        tag = f"{method}_c{args.chains}_n{args.n}_s{args.samples}"
        theta, x, accept, n_div, t = run_segmented(
            kernel, init, burn_in=args.burn_in, num_samples=args.samples,
            seg=args.seg, seed=args.seed, ckpt_dir=args.ckpt_dir, tag=tag)

        # theta holds the CONSTRAINED (sigma^2, beta) (collect_fn: st.position).
        sig = theta[..., 0].ravel()
        beta = theta[..., 1].ravel()
        sanity.append(
            f"{method}: posterior sigma^2 = {sig.mean():.3f} +- {sig.std():.3f}, "
            f"beta = {beta.mean():.5f} +- {beta.std():.5f} "
            f"(generating values 1.91, {1 / 33:.5f})")
        print("sanity:", sanity[-1], flush=True)

        s_per_sample = t / theta.shape[1]
        for block, samp in (("hyper", theta), ("latent", x)):
            mn, md, mx = ess_stats(samp)
            spm = t / mn if mn > 0 else float("inf")
            rows.append(
                f"| {method}_joint | {args.chains} | {theta.shape[1]} | "
                f"{accept:.3f} | {n_div} | {block} | "
                f"({fmt(mn)}, {fmt(md)}, {fmt(mx)}) "
                f"| {spm:.3g} | {t:.1f} | {s_per_sample:.3g} | "
                f"{PAPER_SECONDS_PER_SAMPLE:.1f} | "
                f"{PAPER_SECONDS_PER_SAMPLE / s_per_sample:,.0f}x |")
            print(rows[-1], flush=True)

        # Sidecar record so later single-method invocations re-splice the
        # FULL section instead of overwriting it with their own rows only
        # (advisor round-4 finding: `--method mmala` after a completed
        # rmhmc run must not drop the rmhmc rows).
        rec_f = Path(args.ckpt_dir) / "rows.json"
        recs = json.loads(rec_f.read_text()) if rec_f.exists() else {}
        recs[method] = {"rows": rows[-2:], "sanity": sanity[-1]}
        rec_f.write_text(json.dumps(recs, indent=1))

    if args.calibrate or args.no_splice:
        return

    # Merge every method recorded so far (this run's plus any prior run's).
    rec_f = Path(args.ckpt_dir) / "rows.json"
    recs = json.loads(rec_f.read_text()) if rec_f.exists() else {}
    rows = [r for m in ("rmhmc", "mmala") if m in recs for r in recs[m]["rows"]]
    sanity = [recs[m]["sanity"] for m in ("rmhmc", "mmala") if m in recs]

    section = (
        f"## LGC joint (sigma^2, beta, x) inference -- {args.n}x{args.n} grid "
        f"(D={args.n ** 2} latents + 2 hyperparameters), "
        f"{len(jax.devices())} x {jax.devices()[0].device_kind}\n\n"
        "The paper's most expensive configuration (main_article.pdf sec. 8: "
        "\"5000 posterior\nsamples taking around 90 h\"; "
        "LGC_RMHMC_Paras_LV.m:41-47 / LGC_mMALA_Paras_LV.m:42-43,\n"
        "hyper L=1 eps=0.2 FP 3/10, latent L=20 eps=0.1 / mMALA eps=0.07); "
        f"data: {data_src}.\nNo per-method ESS table exists in the paper, so "
        "the speedup column compares\nwall-clock per kept posterior sample "
        "against the paper's ~64.8 s/sample; ESS\ncolumns are our measured "
        "chain-summed Geyer ESS (hyper = constrained\n(sigma^2, beta); "
        "latent = all field coordinates).\n\n"
        + HEADER + "\n" + "\n".join(rows) + "\n\n"
        "Hyper-posterior sanity: " + "; ".join(sanity) + ".\n"
        "beta (the generating inverse length scale 1/33) is the "
        "slowest-mixing\ncoordinate of the joint problem: at the hyper min "
        "ESS above, method-to-method\nbeta means are resolved only to a few "
        "posterior-sd/sqrt(minESS) units, and the\nmMALA hyper block "
        "(one Langevin step per sweep) explores beta more slowly than\n"
        "the RMHMC block -- the reference's own joint runs share this "
        "constraint\n(paper sec. 10 reports the configuration as its "
        "hardest)."
    )
    text = RESULTS.read_text() if RESULTS.exists() else "# RESULTS\n"
    RESULTS.write_text(splice(text, "lgc-joint", section))
    print(f"=== wrote section lgc-joint to {RESULTS}", flush=True)


if __name__ == "__main__":
    main()

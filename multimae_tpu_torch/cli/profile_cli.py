"""Where the pretraining CLI's step time goes on the card, fed by the
loader and on synthetic batches.

    python -m multimae_tpu_torch.cli.profile_cli [--batches 32 128] [--workers 6]

For each batch size it writes a tree of 16 batches of random 256 x 320
PNG samples under build/profile_cli/ (deleted afterwards), runs
`run_pretraining_multimae` with the flagship YAML for one epoch of 16
steps with `--profile_dir` (torch.profiler over steps 10-13), once on
synthetic batches and once from the tree, and prints per run: the median
host time of a step (steps 1-15), the share of steps 1-15 spent waiting
for the next batch, and from the trace the device time per step, the
kernels' span per step, the card's busy share of that span and the
largest kernels by device time.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import time
from pathlib import Path

YAML = Path(__file__).resolve().parents[2] / "cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml"
BUILD = Path(__file__).resolve().parents[2] / "build" / "profile_cli"
STEPS = 16
PROFILED = 4  # steps 10-13


def trace_summary(trace: Path):
    """(device ms per step, kernel span ms per step, [(kernel, ms per step)])."""
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError(f"{trace} holds no kernel events")
    span = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    by_name = {}
    for e in kernels:
        name = e["name"].split("(")[0].removeprefix("void ")[:60]
        by_name[name] = by_name.get(name, 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    per_step = 1e3 * PROFILED  # trace times are in us
    return (sum(e["dur"] for e in kernels) / per_step, span / per_step,
            [(n, d / per_step) for n, d in top])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[32, 128])
    parser.add_argument("--workers", type=int, default=6)
    opts = parser.parse_args()

    from multimae_tpu_torch.cli.run_pretraining_multimae import get_args
    from multimae_tpu_torch.cli.run_pretraining_multimae import main as train
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    shutil.rmtree(BUILD, ignore_errors=True)
    try:
        for batch in opts.batches:
            tree = BUILD / f"tree{batch}"
            t0 = time.perf_counter()
            write_random_tree(str(tree), batch * STEPS, (256, 320))
            print(f"tree of {batch * STEPS} samples written in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            for kind in ("synthetic", "loader"):
                trace_dir = BUILD / f"{kind}{batch}"
                args = ["-c", str(YAML), "--batch_size", str(batch), "--warmup_epochs", "0",
                        "--epochs", "1", "--num_workers", str(opts.workers), "--no_auto_resume",
                        "--profile_dir", str(trace_dir)]
                args += (["--synthetic_data", "--synthetic_steps_per_epoch", str(STEPS)]
                         if kind == "synthetic" else ["--data_path", str(tree)])
                steps = train(get_args(args))["steps"][1:]
                wait = sum(r["wait_s"] for r in steps)
                share = wait / (wait + sum(r["step_s"] for r in steps))
                device, span, top = trace_summary(trace_dir / "trace_rank0.json")
                print(f"batch {batch} {kind}: median step "
                      f"{statistics.median(r['step_s'] for r in steps) * 1e3:.3f} ms, data wait "
                      f"{share:.4f} of steps 1-{STEPS - 1}; steps 10-13: device {device:.3f} ms "
                      f"per step over a kernel span of {span:.3f} ms, busy {device / span:.4f}",
                      flush=True)
                print("  largest kernels, ms per step: "
                      + ", ".join(f"{n} {d:.3f}" for n, d in top), flush=True)
    finally:
        shutil.rmtree(BUILD, ignore_errors=True)


if __name__ == "__main__":
    main()

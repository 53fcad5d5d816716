"""Readings that the limits of a cell's check are set from, for many seeds
in one process: each seed goes through the cell's own runner as a run of
the benchmark does (set-up, a window of ``--seconds`` at the cell's load,
release, check), and on the ``--control-seeds`` each of the runner's
controls and planted faults (``Runner.controls()``: the plain reference in
fp8, and for a training cell half the batch left out, each in the
program's place) is judged by the same comparison as the program.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2 --seconds 20 --out calib.jsonl

A serving cell's window has to finish the requests its check samples; a
training cell's check reads the steps of set-up, so a short window does.
One JSON line per seed goes to ``--out`` and to standard output: for the
program and for each control, ``correct`` and each number compared beside
its limit.  The benchmark's own runs never run the controls.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, trace  # noqa: E402


def verdict(compared, win):
    return {"correct": harness.judge(compared, win),
            "compared": {k: {"value": float(v), "limit": float(lim)}
                         for k, (v, lim) in compared.items()}}


def seed_record(cell, config, seed, seconds, control, device="cuda"):
    """The program's verdict on ``seed`` and, with ``control``, each
    control's, by the name ``Runner.controls()`` gives it."""
    drv = harness.runner_class(cell["kind"])(cell, config, seed, device)
    drv.setup()
    win = drv.window(seconds, trace.Tracer(False))
    drv.release()
    rec = {"program": verdict(drv.check(), win),
           "attempted": int(win.attempted), "e2e": win.e2e}
    if control:
        for name, compared in drv.controls().items():
            rec[name] = verdict(compared, win)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs the CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    config = harness.load_config(cell["config"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            rec = seed_record(cell, config, seed, args.seconds,
                              seed in controls)
            rec.update(workload=args.workload, seed=seed,
                       seconds=time.perf_counter() - t0)
            line = json.dumps(rec)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --seq-len 128 --batch 8 [--reduced] [--compress] \
        [--remat {none,dots,full}] [--device cpu]

Twin of ``repro.launch.train`` with the same flags; it trains on the CUDA
card unless ``--device`` names another.  ``--compress`` turns on the
GradCompression service (int8, error feedback); ``--remat`` picks the
per-layer recomputation policy.  ``--microbatches`` is accepted and, as
in the reference, changes nothing: the launcher builds a Trainer without
a mesh, which ignores it (``Trainer(mesh=...)`` is the one that
accumulates).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.services.compression import (CompressionConfig,
                                                   GradCompression)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (0 = config value)")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) config")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "coyote_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = ShapeConfig("cli_train", "train", args.seq_len, args.batch)

    comp = (GradCompression(CompressionConfig(bits=8, error_feedback=True))
            if args.compress else None)
    tcfg = TrainConfig(
        steps=args.steps, log_every=max(args.steps // 20, 1),
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        microbatches=args.microbatches, remat=args.remat,
        seed=args.seed, fail_at_step=args.fail_at, compression=comp,
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps))

    trainer = Trainer(cfg, shape, tcfg, device=args.device)
    result = trainer.run()
    print(json.dumps({"result": result,
                      "log": trainer.metrics_log[-5:]}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

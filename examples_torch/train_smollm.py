"""End-to-end driver: train a ~100M-parameter model for a few hundred steps.

The port of ``examples/train_smollm.py``: smollm-135m at full width and
depth (135M params — the deliverable's ~100M model), shortened sequence,
with the production loop: async checkpoints, an injected node failure +
auto-restart, a straggler host, and int8+EF gradient compression on the
DP path.  Attention runs the flash-attention CUDA kernels on the card.

    PYTHONPATH=src python examples_torch/train_smollm.py [--steps 300]

``--reduced`` trains the reduced config instead (a quick look on the
CPU: ``--reduced --device cpu``).
"""
import argparse
import json
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.services.compression import (CompressionConfig,
                                                   GradCompression)
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config, not the full 135M one")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh one "
                         "under the temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-135m")          # full 135M-param config
    if args.reduced:
        cfg = cfg.reduced()
    print(f"training {cfg.arch_id}: {cfg.n_params()/1e6:.0f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}")
    shape = ShapeConfig("e2e", "train", args.seq_len, args.batch)
    tcfg = TrainConfig(
        steps=args.steps,
        log_every=max(args.steps // 10, 1),
        ckpt_every=max(args.steps // 4, 10),
        ckpt_dir=args.ckpt_dir or tempfile.mkdtemp(
            prefix="coyote_e2e_smollm"),
        fail_at_step=args.steps // 2,        # injected failure -> restart
        straggler_steps=(args.steps // 3,),  # one slow host batch
        straggler_delay_s=1.0,
        batch_timeout_s=0.5,
        compression=GradCompression(CompressionConfig(bits=8)),
        opt=AdamWConfig(lr=6e-4, warmup_steps=10, total_steps=args.steps),
        seed=0)
    trainer = Trainer(cfg, shape, tcfg, device=device)
    result = trainer.run()
    print(json.dumps(result, indent=1))
    print("loss curve:", [round(m["loss"], 3) for m in trainer.metrics_log])
    assert result["restarts"] == 1, "failure injection should trigger once"
    first = trainer.metrics_log[0]["loss"]
    last = trainer.metrics_log[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'OK: decreasing' if last < first else 'WARN'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

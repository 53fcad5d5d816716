"""Roofline report generator: dry-run JSON cache -> markdown tables.

    PYTHONPATH=src python -m repro_torch.telemetry.report > experiments/ROOFLINE.md
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List

DRYRUN = Path(__file__).resolve().parents[3] / "experiments" / "dryrun"


def load(mesh: str) -> List[Dict]:
    out = []
    d = DRYRUN / mesh
    if not d.exists():
        return out
    for f in sorted(d.glob("*.json")):
        out.append(json.loads(f.read_text()))
    return out


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x:.2e}"
    return f"{x:.3f}"


def table(mesh: str) -> str:
    rows = load(mesh)
    lines = [
        f"### Mesh `{mesh}`",
        "",
        "| arch | shape | variant | status | compute_s | memory_s | "
        "collective_s | dominant | useful | frac | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in rows:
        tag = rec.get("tag", "") or "baseline"
        if rec["status"] == "skipped":
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | {tag} | skipped | - | -"
                f" | - | - | - | - | {rec.get('reason', '')[:60]} |")
            continue
        if rec["status"] != "ok":
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | {tag} | ERROR | - | -"
                f" | - | - | - | - | {rec.get('error', '')[:60]} |")
            continue
        r = rec["roofline"]
        note = ""
        if tag != "baseline":
            note = ", ".join(f"{k}={v}" for k, v in
                             rec.get("bundle_kw", {}).items())[:60]
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {tag} | ok | "
            f"{_fmt_s(r['compute_s'])} | {_fmt_s(r['memory_s'])} | "
            f"{_fmt_s(r['collective_s'])} | {r['dominant']} | "
            f"{r['useful_flops_ratio']:.3f} | {r['roofline_fraction']:.4f} |"
            f" {note} |")
    lines.append("")
    return "\n".join(lines)


def main() -> int:
    print("# Roofline report (generated from experiments/dryrun/)\n")
    print("Terms per §Roofline: seconds/step/device on H100 SXM constants "
          "(989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink each way); "
          "`useful` = MODEL_FLOPS / compiled FLOPs; `frac` = useful-MFU "
          "at the dominant bound.\n")
    for mesh in ("pod", "multipod"):
        print(table(mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

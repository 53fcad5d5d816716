"""Quickstart: deploy a neural network through the shell in <10 lines.

The port of ``examples/quickstart.py``: the paper's Code 3 claim —
GPU-like UX for FPGA-class infrastructure — on the PyTorch shell, whose
slot runs the network on the CUDA card:

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.apps import CoyoteOverlay
from repro_torch.core import Shell, ShellConfig
from repro_torch.core.services import MMUConfig
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1024,
                    help="feature rows to predict")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- the <10 lines -------------------------------------------------------
    shell = Shell(ShellConfig.make(services={"mmu": MMUConfig()}),
                  device=device)
    shell.build()                                # synthesize the shell once
    overlay = CoyoteOverlay(shell, slot=0)       # the NN "overlay"
    overlay.program_fpga()                       # partial reconfiguration
    X = np.random.RandomState(0).randn(args.rows, 593).astype(np.float32)
    pred = overlay.predict(X, batch_size=256)    # streamed inference
    # -------------------------------------------------------------------------

    print("predictions:", pred.shape, "| first 4:", pred[:4, 0].round(3))
    print("slot status:", shell.vfpgas[0].status())
    print("compile cache:", shell.static.compile_cache.stats())
    shell.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

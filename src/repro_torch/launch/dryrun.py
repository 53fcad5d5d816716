"""Multi-pod dry run: build every (arch x shape x mesh) cell's step as one
rank of the production mesh sees it, on ``meta`` tensors.

Twin of ``repro.launch.dryrun``, with its CLI and record keys:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k --mesh pod

The reference lowers and compiles each cell for 512 placeholder host
devices.  Eager PyTorch compiles nothing and runs one process per rank,
so here ``run_cell`` creates torch's fake process group of 256 (``pod``)
or 512 (``multipod``) ranks in this one process (rank 0; every
collective returns at once), builds the production ``DeviceMesh`` on it,
and runs rank 0's step once on ``meta`` tensors of its block shapes
(``StepBundle.local_args``), collectives included: nothing is allocated
and no device is touched, as the reference's dry run is compile-only.
It is the port's one entry point that needs no card.

A record holds per-rank parameter, optimizer, cache and batch bytes (the
shard shapes), FLOPs from ``FlopCounterMode`` over the rank's step
(``telemetry.roofline.analyze``) and the collectives the step issued
through its collective service (counts, result bytes, ring wire bytes).
The reference's ``compile_s``, XLA's ``memory_analysis`` and
``cost_analysis`` and its ``discount_scope`` have no eager counterpart:
the first three keys are kept, null, and ``no_eager_counterpart`` says
why for each; ``lower_s`` is the bundle's build and ``run_s`` the rank's
step on meta tensors.  Records go to
``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json`` (the
reference's go to ``experiments/dryrun``), so a sweep is resumable.

``run_cell`` creates the fake group and destroys it, and refuses to run in
a process that already has a process group.  Like the reference's, this
module is a CLI: tests run it as a subprocess.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ALL_SHAPES, ARCHS, get_config, get_shape
from repro_torch.configs.base import shape_applicable
from repro_torch.core.services.collectives import CollectiveService
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.steps import make_bundle
from repro_torch.models import transformer as T
from repro_torch.models.sharding import shard_shape
from repro_torch.telemetry import roofline as R

DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
NO_EAGER_COUNTERPART = {
    "compile_s": "eager PyTorch compiles nothing",
    "memory_analysis": "XLA's compiled-module memory analysis; see "
                       "per_rank_bytes for the state's shard bytes",
    "cost_analysis": "XLA's cost analysis of the compiled module; the "
                     "roofline's FLOPs come from FlopCounterMode",
    "discount_scope": "XLA regions fused into one Pallas kernel",
}


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "run_cell builds the production mesh on a fake process group "
            "of its own; this process already has a process group")
    dist.init_process_group("fake", world_size=world, rank=0,
                            store=FakeStore())


def _block_bytes(tree, shardings) -> int:
    """The bytes of this rank's blocks of ``tree`` (tensors of global
    shapes) under ``shardings``."""
    total = 0

    def add(x, sh):
        nonlocal total
        total += (math.prod(shard_shape(x.shape, sh.mesh, sh.spec))
                  * x.element_size())
    pytree.tree_map(add, tree, shardings)
    return total


def _per_rank_bytes(cfg, shape, bundle, kw) -> dict:
    args, ins = bundle.abstract_args, bundle.in_shardings
    out = {"params": _block_bytes(args[0], ins[0]), "optimizer": 0,
           "cache": 0, "batch": 0}
    if shape.kind == "train":
        out["optimizer"] = _block_bytes(args[1], ins[1])
        out["batch"] = _block_bytes(args[2], ins[2])
    elif shape.kind == "prefill":
        out["batch"] = _block_bytes(args[1], ins[1])
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                             dtype=kw.get("cache_dtype", torch.bfloat16),
                             device="meta", enc_seq=cfg.encoder_seq_len)
        out["cache"] = _block_bytes(cache, bundle.out_shardings[1])
    else:
        out["cache"] = _block_bytes(args[1], ins[1])
        out["batch"] = _block_bytes(args[2:], ins[2:])
    return out


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, *,
             out_dir: Path = DEFAULT_OUT, force: bool = False,
             bundle_kw=None, tag: str = "") -> dict:
    import torch.distributed as dist
    cfg = get_config(arch_id)
    shape = get_shape(shape_name)
    out_path = out_dir / mesh_kind / f"{arch_id}__{shape_name}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
           "tag": tag, "status": "pending"}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(out_path, rec)
        return rec

    multi = mesh_kind == "multipod"
    _fake_group(512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        chips = mesh_chips(mesh)
        kw = dict(bundle_kw or {})
        svc = CollectiveService()
        t0 = time.perf_counter()
        bundle = make_bundle(cfg, shape, mesh, collectives=svc, **kw)
        args = bundle.local_args()
        t1 = time.perf_counter()
        roof = R.analyze(bundle.jitted(), *args, chips=chips,
                         model_flops=R.model_flops_for(cfg, shape),
                         collectives=svc)
        t2 = time.perf_counter()
        rec.update(
            status="ok",
            step=bundle.name,
            bundle_kw={k: str(v) for k, v in kw.items()},
            chips=chips,
            lower_s=t1 - t0,
            run_s=t2 - t1,
            compile_s=None,
            memory_analysis=None,
            cost_analysis=None,
            per_rank_bytes=_per_rank_bytes(cfg, shape, bundle, kw),
            roofline=roof.as_dict(),
            no_eager_counterpart=NO_EAGER_COUNTERPART,
        )
    except Exception as e:  # a failing cell is a bug in our sharding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    finally:
        dist.destroy_process_group()
    _write(out_path, rec)
    return rec


def _write(path: Path, rec: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in ALL_SHAPES] if args.shape == "all"
              else args.shape.split(","))
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                t0 = time.perf_counter()
                rec = run_cell(arch, shape, mesh_kind, out_dir=args.out,
                               force=args.force)
                dt = time.perf_counter() - t0
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_err += st == "error"
                extra = ""
                if st == "ok":
                    r = rec["roofline"]
                    extra = (f"dom={r['dominant']} "
                             f"c={r['compute_s']:.3e}s m={r['memory_s']:.3e}s "
                             f"x={r['collective_s']:.3e}s "
                             f"frac={r['roofline_fraction']:.3f}")
                elif st == "error":
                    extra = rec["error"][:120]
                print(f"{st.upper():7s} {mesh_kind}/{arch}/{shape} "
                      f"({dt:.1f}s) {extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} error={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Device meshes over ``torch.distributed``, and a runner for local ranks.

Twin of ``repro.launch.mesh``.  JAX drives every device of a ``Mesh`` from
one process; ``torch.distributed`` runs one process per rank, each
executing the same program.  A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, built over
an initialized default process group: ``("data", "model")`` on a host or
a pod, ``("pod", "data", "model")`` across pods.  ``mesh.get_group(name)``
is a dim's process group.

Defined as FUNCTIONS: importing this module creates no process group and
touches no device.

``run_ranks`` is the port's counterpart of forcing host devices: it
starts ``world`` local ranks (the ``spawn`` start method, a ``file://``
rendezvous in a temporary directory, so concurrent runs never share a
port), gives every process group an explicit timeout and returns each
rank's result.  The tests run their multi-rank cases through it; on the
card several ranks share ``cuda:0`` over gloo.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence, Tuple

import torch

#: per-collective timeout (seconds) of every group ``run_ranks`` creates
DEFAULT_TIMEOUT_S = 60.0


def _build_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev_type = torch.device("cuda" if device is None else device).type
    mesh = init_device_mesh(dev_type, shape, mesh_dim_names=names)
    # the mesh's sub-groups take the backend's default timeout (30 min for
    # gloo), not the default group's: give each an explicit one, so a
    # collective that one rank never joins fails instead of hanging
    timeout = datetime.timedelta(seconds=_state.timeout_s)
    for name in names:
        dist.distributed_c10d._set_pg_timeout(timeout, mesh.get_group(name))
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (data=16, model=16) = 256 ranks; two pods add a leading
    ``pod`` dim (512).  DP/FSDP runs on (pod, data); TP on model."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    _require_world(shape, f"make_production_mesh(multi_pod={multi_pod})")
    return _build_mesh(shape, names, device)


def _require_world(shape, what: str) -> None:
    import torch.distributed as dist
    n = 1
    for s in shape:
        n *= s
    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else None)
    if have != n:
        seen = ("has no initialized process group" if have is None
                else f"is one of {have} ranks")
        raise RuntimeError(
            f"{what} needs {n} ranks but this process {seen}; start {n} "
            f"ranks with repro_torch.launch.mesh.run_ranks(fn, {n}, ...) "
            f"(or torchrun --nproc-per-node {n}) and build the mesh in "
            "each of them (see tests/test_torch_mesh_serving.py)")


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``(data, model)`` mesh over the ranks of the default process
    group.  ``device=None`` means the CUDA card; tests pass ``"cpu"``.

    Raises a descriptive :class:`RuntimeError` (not a bare assert) when
    the world size is not ``data * model``, naming how to start the
    ranks."""
    _require_world((data, model), f"make_host_mesh(data={data}, "
                                  f"model={model})")
    return _build_mesh((data, model), ("data", "model"), device)


def make_mesh(shape: Sequence[int], names: Sequence[str], *, device=None):
    """A mesh of any named shape over the default group (the reference
    builds these with ``compat.make_mesh``)."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    _require_world(shape, f"make_mesh({shape}, {names})")
    return _build_mesh(shape, names, device)


def mesh_chips(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= int(s)
    return n


# ------------------------------------------------------------ local ranks --
class _State:
    """The process's collective timeout: ``run_ranks`` sets its own in
    each rank; a process started otherwise (torchrun) keeps the default."""
    timeout_s: float = DEFAULT_TIMEOUT_S


_state = _State()


def _rank_main(rank: int, world: int, fn, args, backend: str, device: str,
               init_file: str, timeout_s: float, results) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _state.timeout_s = timeout_s
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, re-raised there
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *args, device: str,
              backend: str = "gloo", timeout_s: float = DEFAULT_TIMEOUT_S,
              deadline_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes,
    each a rank of one default process group, and return their results in
    rank order.

    ``fn`` must be importable by its module path (``spawn``); its result
    must pickle.  ``device`` (required: no rank is put on the CPU unless
    the caller asks) is each rank's device: ``"cpu"``, a card
    (``"cuda:0"``: every rank on it) or ``"cuda"`` (rank ``r`` on card
    ``r % count``, one card a rank for NCCL).  Every process group gets
    ``timeout_s`` per collective; the whole run gets ``deadline_s``.
    Raises :class:`RuntimeError` with the failing rank's traceback if any
    rank raises, dies or misses the deadline; every process is ended
    before it returns or raises."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, fn, args, backend, device,
                               os.path.join(tmp, "rendezvous"), timeout_s,
                               results))
             for r in range(world)]
    got: dict = {}
    failed: List[Tuple[int, str]] = []
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        while len(got) + len(failed) < world:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got
                        and r not in {f[0] for f in failed}]
                if dead:
                    # a rank that died without reporting (a signal): give
                    # the others a moment to report their own errors
                    failed += [(r, f"rank {r} exited with code "
                                   f"{procs[r].exitcode} without a result")
                               for r in dead]
                if time.monotonic() > end:
                    late = [r for r in range(world) if r not in got
                            and r not in {f[0] for f in failed}]
                    failed += [(r, f"rank {r} gave no result within "
                                   f"{deadline_s} s") for r in late]
                continue
            if ok:
                got[rank] = out
            else:
                failed.append((rank, out))
            if failed:
                # one rank failed: its peers may block in a collective
                # until their timeout; end them after a short grace
                end = min(end, time.monotonic() + 5.0)
    finally:
        procs = [p for p in procs if p.pid is not None]     # started
        for p in procs:
            p.join(timeout=5.0 if not failed else 0.1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        failed.sort()
        raise RuntimeError(
            f"{len(failed)} of {world} ranks failed:\n" + "\n".join(
                f"--- rank {r} ---\n{msg}" for r, msg in failed))
    return [got[r] for r in range(world)]

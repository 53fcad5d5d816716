"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric is a file that the harness finds by name under its base
directory (``perfbench/`` by default):

  * ``workloads/<cell>.json``: the names of its configuration and traffic
    mix, the engine's settings where it serves, the limits of the
    correctness check;
  * ``configs/<config>.json``: the widths, the dtype, the source and the
    names of its weight maker and plain reference;
  * ``traffic/<mix>.json``: a traffic mix, its ``kind`` and parameters;
  * ``traffic/<kind>.py``: the runner of that kind of traffic, a class
    ``Runner(cell, config, seed, device)`` with ``setup()``,
    ``window(seconds, tracer)``, ``release()``, ``check()`` (each number
    compared: ``{name: (value, limit)}``) and ``controls()`` (the same of
    each control and planted fault, by its name; only ``calibrate.py``
    calls it, the benchmark's runs never do);
  * ``metrics/<metric>.py``: ``read(run)``, one per-layer metric, or None
    where the run holds nothing for it to read;
  * ``reference/<name>.py``: a configuration's plain reference.

Which metrics a cell reports is read from ``BENCHMARK.json`` at the root
of the checkout.  The program under test is ``repro_torch`` (under
``src/``); nothing here imports the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from perfbench import trace as tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_cell(name: str, base: Path = BENCH) -> Dict[str, Any]:
    """The cell's file, its traffic mix's parameters in ``cell["traffic"]``
    and their kind in ``cell["kind"]``."""
    cell = load_json(Path(base) / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["traffic"] = load_json(Path(base) / "traffic"
                                / f"{cell['traffic']}.json")
    cell["kind"] = cell["traffic"]["kind"]
    return cell


def load_config(name: str, base: Path = BENCH) -> Dict[str, Any]:
    cfg = load_json(Path(base) / "configs" / f"{name}.json")
    cfg["name"] = name
    return cfg


def load_module(path: Path, tag: str):
    """A module of the benchmark, loaded from its file (a metric's name
    may hold dots)."""
    name = "perfbench_" + "".join(c if c.isalnum() else "_" for c in tag)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def runner_class(kind: str, base: Path = BENCH):
    return load_module(Path(base) / "traffic" / f"{kind}.py",
                       f"traffic_{kind}").Runner


def reference_module(name: str, base: Path = BENCH):
    return load_module(Path(base) / "reference" / f"{name}.py",
                       f"reference_{name}")


def metric_reader(name: str, base: Path = BENCH):
    return load_module(Path(base) / "metrics" / f"{name}.py",
                       f"metric_{name}").read


def cell_metrics(bench: Dict[str, Any], cell: str):
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in moved)]
    return e2e, per


def use_program() -> None:
    """Put the program's package (``src/repro_torch``) on the path."""
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise RuntimeError(f"the program is not in this checkout: no "
                           f"{src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def model_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` of a configuration file."""
    use_program()
    from repro_torch.configs.base import ModelConfig, SSMConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    if "block_pattern" in kw:
        kw["block_pattern"] = tuple(kw["block_pattern"])
    return ModelConfig(**kw)


def torch_dtype(name: str):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each module's name compared whole up to its first dot."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    """What a runner's ``window`` returns: the end-to-end values by name,
    the counters its per-layer metrics read, requests or steps attempted
    and failed, and optionally the device's memory peak (where the runner
    reset the allocator's peak at the window's start)."""
    e2e: Dict[str, float]
    counters: Dict[str, Any]
    attempted: int
    failed: int
    memory_peak_bytes: Optional[int] = None


@dataclasses.dataclass
class Run:
    """What a per-layer metric's ``read`` is given."""
    cell: Dict[str, Any]
    config: Dict[str, Any]
    counters: Dict[str, Any]
    trace: Optional[tracing.Trace]


def device_info(device: str, chips: int, peak: int) -> Dict[str, Any]:
    if device == "cuda":
        import torch
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def judge(compared: Dict[str, tuple], win: Window) -> bool:
    """``correct``: every number compared within its limit, something
    attempted and nothing failed."""
    return (bool(compared) and win.failed == 0 and win.attempted > 0
            and all(v <= lim for v, lim in compared.values()))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", base: Path = BENCH,
             bench: Optional[Dict[str, Any]] = None,
             cell: Optional[Dict[str, Any]] = None,
             config: Optional[Dict[str, Any]] = None,
             t_start: Optional[float] = None) -> Dict[str, Any]:
    """One run of cell ``name``; returns the result line as a dict.
    ``cell`` and ``config`` replace the files of those names (the CPU
    tests run a cell at a reduced size this way)."""
    t_start = time.perf_counter() if t_start is None else t_start
    use_program()
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    cell = load_cell(name, base) if cell is None else cell
    config = load_config(cell["config"], base) if config is None else config
    e2e_defs, per_defs = cell_metrics(bench, name)
    drv = runner_class(cell["kind"], base)(cell, config, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    tracer = tracing.Tracer(trace and device == "cuda")
    win = drv.window(seconds, tracer)
    tracer.stop()
    peak = win.memory_peak_bytes
    if peak is None and device == "cuda":
        import torch
        peak = torch.cuda.max_memory_allocated()
    drv.release()
    traced = tracer.result()
    compared = drv.check()

    metrics: Dict[str, Dict[str, Any]] = {}
    line: Dict[str, Any] = {}
    if trace:
        run = Run(cell, config, win.counters, traced)
        for m in per_defs:
            v = metric_reader(m["name"], base)(run)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(win.e2e, setup_s=setup_s)
        for m in e2e_defs:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    line.update(correct=judge(compared, win), attempted=int(win.attempted),
                failed=int(win.failed), metrics=metrics,
                device=device_info(device, int(cell.get("chips", 1)),
                                   peak or 0))
    if trace and traced is not None and not traced.empty:
        line["device"]["busy_s"] = tracing.busy_seconds(traced)
        line["device"]["window_s"] = traced.wall_s
        line["breakdown"] = tracing.breakdown(traced)
    line["compared"] = {k: {"value": float(v), "limit": float(lim)}
                        for k, (v, lim) in compared.items()}
    return line

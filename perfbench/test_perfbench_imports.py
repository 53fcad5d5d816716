"""The benchmark measures the port alone: no file under ``perfbench/``
imports a module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``repro`` (compared whole: ``repro_torch`` is the program), and every
module of it, with what the runners load of the port, imports with those
blocked."""
import ast
import os
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_CHILD = r"""
import importlib, importlib.abc, pathlib, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
from perfbench import harness
harness.use_program()
n = 0
for sub in ("traffic", "metrics", "reference"):
    for p in sorted((harness.BENCH / sub).glob("*.py")):
        harness.load_module(p, f"{sub}_{p.stem}")
        n += 1
for m in ("calibrate", "flops", "run", "smallcells", "trace", "weights"):
    importlib.import_module(f"perfbench.{m}")
    n += 1
for m in ("repro_torch.serve.engine", "repro_torch.core.services.mmu",
          "repro_torch.train.loop", "repro_torch.optim.adamw",
          "repro_torch.kernels.ssd.ssd"):
    importlib.import_module(m)
assert not harness.forbidden_modules(), harness.forbidden_modules()
print(n)
"""


def test_benchmark_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_source_names_the_jax_package():
    bad = [(p.name, m) for p in BENCH.rglob("*.py") for m in _imported(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_forbidden_names_compare_whole_top_level_names():
    from perfbench import harness
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serve.engine", "jaxtyping", "os"]) == []
    assert harness.forbidden_modules(
        ["repro.models", "jaxlib.xla", "flax", "torch"]) == [
            "flax", "jaxlib", "repro"]


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "danube-longdoc", "--seed",
                          "3000000001", "--seconds", "1", "--trace", "0"],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

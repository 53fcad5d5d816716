"""The port stands alone: every ``repro_torch`` module, ``chip_smoke``
and the examples on the port (``examples_torch/``) import with ``jax``
and ``repro`` blocked, and no source of the port names either in an
import statement."""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import importlib.util, pathlib
for path in sorted(pathlib.Path("examples_torch").glob("*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print(len(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20  # every module


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


_TEXT = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.)",
                   re.M)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_source_names_no_jax_or_repro(path):
    tops = {m.split(".")[0] for m in _imported(path)}
    assert not tops & {"jax", "jaxlib", "repro"}, tops
    assert not _TEXT.search(path.read_text())


def test_static_check_tells_repro_from_repro_torch():
    assert _TEXT.search("from repro.serve import x\n")
    assert _TEXT.search("import jax.numpy as jnp\n")
    assert not _TEXT.search("from repro_torch.serve import x\n")
    assert not _TEXT.search("import repro_torch\n")


_TP_CHILD = r"""
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for n in ("repro_torch.launch.mesh", "repro_torch.models.sharding",
          "repro_torch.serve.tp", "repro_torch.serve.disaggregated"):
    importlib.import_module(n)
import torch.distributed as dist
print("initialized" if dist.is_initialized() else "no process group")
"""


def test_tp_modules_import_alone_and_start_no_process_group():
    """The tensor-parallel slice's modules import with ``jax`` and
    ``repro`` blocked, and importing ``launch/mesh`` creates no process
    group (it defines functions; ``run_ranks`` starts ranks on a call)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _TP_CHILD], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "no process group"


_LAUNCH_CHILD = r"""
import importlib, importlib.abc, json, sys, tempfile
from pathlib import Path

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
steps = importlib.import_module("repro_torch.launch.steps")
dryrun = importlib.import_module("repro_torch.launch.dryrun")
import torch.distributed as dist
out = {"after_import": dist.is_initialized()}
tmp = Path(tempfile.mkdtemp())
rec = dryrun.run_cell("smollm-135m", "decode_32k", "pod", out_dir=tmp)
out["cell"] = rec["status"]
out["after_cell"] = dist.is_initialized()
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", rank=0,
                        world_size=1)
try:
    dryrun.run_cell("smollm-135m", "train_4k", "pod", out_dir=tmp)
    out["refused"] = False
except RuntimeError as e:
    out["refused"] = "already has a process group" in str(e)
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_launch_modules_import_alone_and_the_dry_run_owns_its_group():
    """``launch/steps.py`` and ``launch/dryrun.py`` import with ``jax``
    and ``repro`` blocked and start no process group; a dry-run cell
    builds the production mesh on a fake group of its own, runs, and
    leaves no group behind, and it refuses to run in a process that
    already has one."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _LAUNCH_CHILD], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"after_import": False, "cell": "ok", "after_cell": False,
                   "refused": True}

"""The port's serving launcher against the reference's, on the CPU.

``repro_torch.launch.serve.main`` and ``repro.launch.serve.main`` take the
same flags (the port's also ``--device``).  Given the reference's weights
(its ``init_params`` for the seed, converted with numpy) both serve the
same numpy-drawn prompts: the printed stats have the same keys and
completed count, and greedy streams (``--temperature 0``) are identical.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jlaunch
from repro.models import transformer as JT
from repro_torch.launch import serve as launch
from repro_torch.models import transformer as T
from repro_torch.models.params import from_reference

torch.set_num_threads(1)

ARGS = ["--requests", "5", "--max-new", "6", "--batch", "2",
        "--page-size", "16", "--n-pages", "64", "--max-len", "128",
        "--seed", "3"]


def _recorded(monkeypatch, module):
    engines = []

    class Recorded(module.ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(module, "ServingEngine", Recorded)
    return engines


def test_launcher_matches_the_reference_launcher(monkeypatch, capsys):
    def reference_weights(cfg, *, generator, dtype, device):
        jp = JT.init_params(jax.random.PRNGKey(3), jlaunch.get_config(
            cfg.arch_id).reduced(), dtype=np.float32)
        return from_reference(jax.tree.map(np.asarray, jp), device=device)

    ref_engines = _recorded(monkeypatch, jlaunch)
    assert jlaunch.main(ARGS) == 0
    ref = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(T, "init_params", reference_weights)
    engines = _recorded(monkeypatch, launch)
    assert launch.main(ARGS + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(ref)
    assert set(got["mmu"]) == set(ref["mmu"])
    assert got["completed"] == ref["completed"] == 5
    assert got["mmu"]["pages_used"] == 0
    streams = [{r.rid: list(r.out_tokens) for r in e.completed}
               for e in (engines[0], ref_engines[0])]
    assert streams[0] == streams[1]
    assert all(len(t) == 6 for t in streams[0].values())


def test_launcher_serves_reduced_on_the_cpu(capsys):
    """Its own seeded weights; ``--reduced`` is on whatever the flags say
    (the reference's quirk); sampled requests complete too."""
    assert launch.main(ARGS + ["--temperature", "0.8", "--device",
                               "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["completed"] == 5 and out["tokens"] == 30
    assert out["mmu"]["pages_used"] == 0


def test_launcher_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(ARGS)

"""The ten examples on the port (``examples_torch/``), each the twin of
the file of the same name in ``examples/``.

Each example's ``main(argv)`` runs in process on the CPU at a cut-down
size; the test holds it to what the example itself asserts (its own
``assert``s and ``SystemExit`` checks run inside ``main``) and to the
line it prints when it is complete.  No timing is checked.  Without
``--device`` an example runs on the CUDA card, and without a card it
refuses before doing any work.
"""
import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"

torch.set_num_threads(1)

# example -> (small-size arguments, a line it prints once complete)
CASES = {
    "quickstart": (["--rows", "256"], "predictions: (256, 1)"),
    "serve_paged": (["--requests", "4"],
                    "OK: all requests served, pages reclaimed"),
    "train_smollm": (["--reduced", "--steps", "24", "--seq-len", "16",
                      "--batch", "2"], '"restarts": 1'),
    "multitenant_shell": (["--kib", "8", "--qos-transfers", "6"],
                          "weighted QoS (3:1)"),
    "hotswap_port": (["--invocations", "20"],
                     "gold: 20 submitted -> 20 completed"),
    "fault_recovery": ([], "[ok] token-for-token parity across recovery"),
    "fleet_autoscale": (["--max-new", "12"], "all finished exactly once"),
    "gateway_serving": (["--requests", "6", "--long-prompt", "96"],
                        "gateway demo OK"),
    "migrate_shell": (["--max-new", "12"], "shell A pages fully released"),
    "prefix_sharing": (["--users", "4"], "OK: prefix sharing pays"),
}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_reference_example_has_a_port():
    ref = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    assert sorted(p.name for p in EXAMPLES.glob("*.py")) == ref
    assert sorted(f"{n}.py" for n in CASES) == ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_to_completion_on_the_cpu(name, tmp_path, capsys):
    argv, done = CASES[name]
    if name == "train_smollm":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    assert _load(name).main(argv + ["--device", "cpu"]) == 0
    assert done in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_needs_the_card_unless_asked_for_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(name).main([])

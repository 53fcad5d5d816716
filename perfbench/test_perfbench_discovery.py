"""A cell, a configuration, a traffic mix, a traffic kind and a per-layer
metric are added as files: the harness finds each by its name under its
base directory, with no edit to a file that is there."""
import json
import textwrap

from perfbench import harness

KIND = textwrap.dedent('''
    from perfbench import harness


    class Runner:
        def __init__(self, cell, config, seed, device):
            self.cell, self.config, self.seed = cell, config, seed

        def setup(self):
            self.n = self.cell["traffic"]["items"] * self.config["width"]

        def window(self, seconds, tracer):
            return harness.Window({"items_per_s": self.n / seconds},
                                  {"done": self.n}, self.n, 0)

        def release(self):
            pass

        def check(self):
            return {"items_gap": (0.0, self.cell["limits"]["items_gap"])}
''')

METRIC = textwrap.dedent('''
    def read(run):
        return 2.0 * run.counters["done"]
''')


def _bench():
    return {"end_to_end": [
        {"name": "items_per_s", "unit": "items/s", "workloads": ["toy.cell"]},
        {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "done_twice", "unit": "items",
                       "moves": "items_per_s", "workloads": ["toy.cell"]},
                      {"name": "elsewhere", "unit": "%", "moves": "other"}]}


def _write(base):
    for sub in ("workloads", "configs", "traffic", "metrics"):
        (base / sub).mkdir()
    (base / "workloads" / "toy.cell.json").write_text(json.dumps(
        {"config": "toy-model", "traffic": "toy-mix", "chips": 1,
         "limits": {"items_gap": 0.5}}))
    (base / "configs" / "toy-model.json").write_text(json.dumps(
        {"width": 3}))
    (base / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"kind": "toy_kind", "items": 5}))
    (base / "traffic" / "toy_kind.py").write_text(KIND)
    (base / "metrics" / "done_twice.py").write_text(METRIC)


def test_new_files_are_found_by_name(tmp_path):
    _write(tmp_path)
    cell = harness.load_cell("toy.cell", tmp_path)
    assert cell["kind"] == "toy_kind" and cell["traffic"]["items"] == 5
    assert harness.load_config("toy-model", tmp_path)["width"] == 3
    e2e, per = harness.cell_metrics(_bench(), "toy.cell")
    assert [m["name"] for m in e2e] == ["items_per_s", "setup_s"]
    assert [m["name"] for m in per] == ["done_twice"]


def test_a_run_of_the_new_cell_drives_the_new_kind_and_metric(tmp_path):
    _write(tmp_path)
    plain = harness.run_cell("toy.cell", 1, 2.0, False, device="cpu",
                             base=tmp_path, bench=_bench())
    assert plain["correct"] and plain["attempted"] == 15
    assert plain["metrics"]["items_per_s"]["value"] == 7.5
    assert set(plain["metrics"]) == {"items_per_s", "setup_s"}
    assert list(plain)[-1] == "compared"
    assert plain["compared"] == {"items_gap": {"value": 0.0, "limit": 0.5}}
    traced = harness.run_cell("toy.cell", 1, 2.0, True, device="cpu",
                              base=tmp_path, bench=_bench())
    assert traced["metrics"] == {"done_twice": {"value": 30.0,
                                                "unit": "items"}}


def test_the_benchmarks_cells_and_metrics_have_their_files():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] is not None
        assert (harness.BENCH / "traffic" / f"{cell['kind']}.py").is_file()
        cfg = harness.load_config(w["config"])
        assert (harness.BENCH / "reference"
                / f"{cfg['reference']}.py").is_file()
        e2e, per = harness.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per
        assert all(m["moves"] in names for m in per)
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()

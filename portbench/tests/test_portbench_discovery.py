"""A configuration, a traffic mix, a per-layer metric and a cell, added as
files and entries to a copy of the benchmark, are found by name and run,
with no file of the benchmark edited."""
import hashlib
import json
import pathlib
import shutil
import time

from conftest import ROOT

from portbench.harness import runner, spec as specmod

DRIVER = '''"""A toy driver: a counter per env."""
import torch

from portbench.harness.cell import Cell


def inputs(cfg, traffic, seed, device, rank=0):
    return {"step": traffic["increment"]}


def _cell(cfg, traffic, inputs, device):
    def step(state):
        return state + inputs["step"], ()

    return Cell(envs=cfg["num_envs"], starts=[torch.zeros(cfg["num_envs"], 1, device=device)],
                step=step, fields=lambda s, o: {"count": s}, counts=lambda s: {"toy.count": 7})


def build(cfg, traffic, inputs, device, impl="program", rank=0, world=1):
    return _cell(cfg, traffic, inputs, device)


def reference(cfg, traffic, inputs, device, rank=0, world=1):
    cell = _cell(cfg, traffic, inputs, device)
    inner = cell.step
    cell.step = lambda state, dtype=None: inner(state)
    return cell
'''


def digest(root: pathlib.Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_is_found_by_name(tmp_path):
    src = pathlib.Path(ROOT)
    shutil.copy(src / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(src / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "portbench")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-8", "source": "a test", "file": "portbench/configs/toy-8.json",
                             "reduced": [], "why": "a counter"})
    bench["workloads"].append({"name": "toy-8-count", "config": "toy-8", "traffic": "count",
                               "chips": 1, "why": "counts"})
    bench["per_layer"].append({"name": "toy.count", "unit": "ops", "better": "lower",
                               "source": "program_counter", "layer": "toy", "moves": "env_steps_per_s",
                               "workloads": ["toy-8-count"]})
    if "workloads" in bench["end_to_end"][0]:
        bench["end_to_end"][0]["workloads"].append("toy-8-count")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bp = tmp_path / "portbench"
    (bp / "configs" / "toy-8.json").write_text(json.dumps({"num_envs": 8}))
    (bp / "drivers" / "toy-8.py").write_text(DRIVER)
    (bp / "traffic" / "count.json").write_text(json.dumps(
        {"increment": 2.0, "warmup_steps": 1, "check_steps": 2, "check_within": 5,
         "trace_from": 1, "trace_steps": 2}))
    (bp / "limits" / "toy-8-count.json").write_text(json.dumps({"start_gap": 0.0, "step_gap": 1e-6}))
    (bp / "metrics" / "toy.count.py").write_text(
        "def read(ctx):\n    return ctx.counts.get('toy.count')\n")

    after = digest(bp)
    assert all(after[k] == v for k, v in before.items()), "a file of the benchmark was edited"

    spec = specmod.load("toy-8-count", tmp_path / "BENCHMARK.json")
    assert spec.driver_path == bp / "drivers" / "toy-8.py"
    assert [m["name"] for m in spec.per_layer] == ["toy.count"]
    e2e = [m["name"] for m in spec.end_to_end]
    assert e2e == [m["name"] for m in bench["end_to_end"]]
    t0 = time.perf_counter()
    for trace in (0, 1):
        r = runner.run_rank(spec, 5, 0.2, trace, "cpu", lambda: time.perf_counter() - t0,
                            out=lambda line: None)
        assert r["correct"], r["checks"]
        if trace:
            assert r["metrics"]["toy.count"]["value"] == 7
        else:
            assert set(r["metrics"]) == set(e2e)


def test_every_metric_and_cell_of_the_benchmark_has_its_files():
    bench = json.loads((pathlib.Path(ROOT) / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        spec = specmod.load(w["name"])
        assert spec.driver_path.exists() and spec.limits
        for m in spec.per_layer + spec.end_to_end:
            assert callable(specmod.metric_reader(m["name"]))

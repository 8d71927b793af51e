"""A cell's files, found by the names in BENCHMARK.json.

A workload names a configuration and a traffic mix. The configuration is
`configs/<config>.json` (via its `file` entry) with its driver
`drivers/<config>.py`; the traffic is `traffic/<traffic>.json`; the limits
of the comparison with the reference are `limits/<workload>.json`; each
metric is read by `metrics/<name>.py`. Adding a cell adds files and
entries: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class CellSpec:
    workload: str
    chips: int
    config_name: str
    config: dict  # the configuration file's contents
    traffic_name: str
    traffic: dict
    limits: dict  # compared number -> limit
    driver_path: pathlib.Path
    end_to_end: list  # BENCHMARK.json entries reported with --trace 0
    per_layer: list  # ... and with --trace 1
    root: pathlib.Path = ROOT  # the checkout whose files these are


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: dict, workload: str, e2e_names) -> bool:
    """A per-layer metric is read in the cells its `workloads` lists, or,
    without that key, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e_names


def load(workload: str, bench_file: pathlib.Path = ROOT / "BENCHMARK.json") -> CellSpec:
    """The CellSpec of `workload`; raises KeyError naming an unknown one."""
    bench = _json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file.name}: {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    root = bench_file.parent
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, workload, e2e_names)]
    return CellSpec(
        workload=workload,
        chips=int(cell["chips"]),
        config_name=config["name"],
        config=_json(root / config["file"]),
        traffic_name=cell["traffic"],
        traffic=_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json"),
        limits=_json(root / "portbench" / "limits" / f"{workload}.json"),
        driver_path=root / "portbench" / "drivers" / f"{config['name']}.py",
        end_to_end=e2e,
        per_layer=per_layer,
        root=root,
    )


def load_module(path: pathlib.Path, prefix: str):
    """Import the file at `path` under the name `prefix.<stem>`."""
    name = f"{prefix}.{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The `read(ctx)` of metrics/<name>.py."""
    return load_module(root / "portbench" / "metrics" / f"{name}.py", "portbench_metrics").read

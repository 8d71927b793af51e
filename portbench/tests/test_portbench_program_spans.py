"""The readers of the port's own spans and set-up stages
(harness/spans.py, metrics/sim.*, metrics/setup.*) on synthetic traces, and
a traced run of each cell on the CPU that reports them."""
import json
import pathlib
import types

import pytest

from portbench.harness import sides, spans, spec as specmod
from portbench.harness.trace import WINDOW_SPAN, Trace
from helpers import run, small_spec

PHASES = ("sim.phase_a", "sim.phase_b", "sim.phase_c", "sim.phase_d", "sim.refresh")
TRACE_READERS = tuple(f"{p}.host_ms" for p in PHASES) + ("sim.launches",)


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def synthetic():
    """Two steps: sim.step at 0-40 and 50-90, each phases A-D and the
    refresh; launches 1-4 inside the steps, 5 outside, 6 carried by no
    device operation, 2 carried by two."""
    ev = [X("user_annotation", WINDOW_SPAN, 0, 100),
          X("user_annotation", "simulator", 0, 41)]
    for t0 in (0, 50):
        ev.append(X("user_annotation", "sim.step", t0, 40))
        for i, name in enumerate(PHASES):
            ev.append(X("user_annotation", name, t0 + 8 * i, 1 + i))
    ev += [
        X("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
        X("cuda_runtime", "cudaLaunchKernel", 9, 1, correlation=2),
        X("cuda_runtime", "cudaMemcpyAsync", 55, 1, correlation=3),
        X("cuda_driver", "cuLaunchKernel", 89, 1, correlation=4),
        X("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=5),
        X("cuda_runtime", "cudaEventRecord", 20, 1, correlation=6),
        X("kernel", "k1", 2, 3, correlation=1),
        X("kernel", "k2a", 10, 3, correlation=2),
        X("kernel", "k2b", 14, 3, correlation=2),
        X("gpu_memcpy", "Memcpy DtoD", 56, 2, correlation=3),
        X("kernel", "k4", 90, 3, correlation=4),
        X("kernel", "k5", 46, 3, correlation=5),
    ]
    return Trace(ev)


def ctx(trace=None):
    return types.SimpleNamespace(trace=trace or synthetic(), profiled_steps=2, counts={},
                                 captured={}, envs=8, window=None, windows=[], setup_s=1.5)


def read(name, c):
    return specmod.metric_reader(name)(c)


@pytest.mark.parametrize("i,phase", list(enumerate(PHASES)))
def test_phase_host_ms_a_profiled_step(i, phase):
    # each step's span of phase i lasts 1 + i us: 2 (1 + i) us over 2 steps
    assert read(f"{phase}.host_ms", ctx()) == pytest.approx((1 + i) / 1e3)


def test_launches_count_each_carried_correlation_once_inside_the_step():
    # 1, 2 (two kernels), 3 (a copy), 4 (a driver launch) inside; 5 outside;
    # 6 carried by nothing
    assert read("sim.launches", ctx()) == pytest.approx(4 / 2)
    assert spans.launches(ctx(), "simulator") == pytest.approx(2 / 2)


@pytest.mark.parametrize("name", TRACE_READERS)
def test_a_reader_with_no_span_to_read_is_left_out(name):
    empty = Trace([X("user_annotation", WINDOW_SPAN, 0, 10),
                   X("user_annotation", "simulator", 0, 10),
                   X("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
                   X("kernel", "k", 2, 3, correlation=1)])
    assert read(name, ctx(empty)) is None


@pytest.mark.parametrize("stage", ["setup.build", "setup.finalize"])
def test_stage_readers_read_the_ports_stage_seconds(monkeypatch, stage):
    trace = sides.port("utils.trace")
    monkeypatch.setitem(trace.stage_s, stage, 2.5)
    assert read(f"{stage}_s", ctx()) == 2.5


@pytest.mark.parametrize("stage", ["setup.build", "setup.finalize"])
def test_stage_readers_without_the_ports_trace_module(monkeypatch, stage):
    def missing(name):
        raise ModuleNotFoundError(f"No module named {sides.PORT}.{name}",
                                  name=f"{sides.PORT}.{name}")

    monkeypatch.setattr(sides, "port", missing)
    assert read(f"{stage}_s", ctx()) is None

    def broken(name):
        raise ModuleNotFoundError("No module named numpy", name="numpy")

    monkeypatch.setattr(sides, "port", broken)
    with pytest.raises(ModuleNotFoundError):
        read(f"{stage}_s", ctx())


@pytest.mark.parametrize("workload", ["franka-4096-track", "balls-1080-pile"])
def test_a_traced_run_reports_the_program_metrics_of_its_cell(workload):
    bench = json.loads((pathlib.Path(specmod.ROOT) / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer"]
            if m["name"].startswith(("sim.", "setup.")) and workload in m["workloads"]}
    assert want
    res = run(small_spec(workload, trace_from=0), seconds=0.5, trace=1)
    assert want <= set(res["metrics"]), want - set(res["metrics"])
    assert res["correct"]

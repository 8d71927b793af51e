"""The metric readers on small synthetic traces and windows."""
import types

import numpy as np
import pytest
import torch

from portbench.harness import spec as specmod
from portbench.harness.trace import WINDOW_SPAN, Trace, union


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def synthetic():
    return Trace([
        X("user_annotation", WINDOW_SPAN, 0, 100),
        X("user_annotation", "simulator", 0, 50),
        X("user_annotation", "contact", 10, 20),
        X("user_annotation", "control", 60, 20),
        X("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        X("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
        X("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=3),
        X("kernel", "k_contact", 10, 20, correlation=1),
        X("kernel", "k_sim", 20, 20, correlation=2),
        X("kernel", "ncclDevKernel_AllGather", 60, 10, correlation=3),
        X("gpu_user_annotation", "not_work", 0, 100),
    ])


def ctx(**kw):
    base = dict(trace=synthetic(), profiled_steps=2, counts={}, captured={}, envs=8,
                window=None, windows=[], setup_s=1.5)
    base.update(kw)
    return types.SimpleNamespace(**base)


def read(name, c):
    return specmod.metric_reader(name)(c)


def test_busy_is_the_union_of_device_intervals_not_their_sum():
    t = synthetic()
    assert union([(10, 30), (20, 40), (60, 70)]) == [(10, 40), (60, 70)]
    assert t.busy_us() == 40  # 30 + 10, where the sum of durations is 50
    assert read("device.idle_pct", ctx()) == pytest.approx(60.0)


def test_span_metrics_per_profiled_step():
    c = ctx()
    assert read("simulator.host_ms", c) == pytest.approx((50 - 20) / 1e3 / 2)  # self time
    assert read("control.host_ms", c) == pytest.approx(20 / 1e3 / 2)


def test_a_metric_with_nothing_to_read_is_left_out():
    empty = Trace([X("user_annotation", WINDOW_SPAN, 0, 10)])
    c = ctx(trace=empty)
    for name in ("control.host_ms", "simulator.host_ms", "device.idle_pct",
                 "sphere_world.roofline_pct"):
        assert read(name, c) is None, name
    assert read("control.ops", c) is None


def test_breakdown_names_gaps_by_the_host_span():
    b = synthetic().breakdown()
    assert b["device_ops"][0] == ["k_contact", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["harness", pytest.approx(30e-6)]  # 70-100: in no span
    names = {n for n, _ in b["idle_gaps"]}
    assert names == {"simulator", "harness"}  # 0-10 in simulator, 40-60 in simulator


def test_end_to_end_readers():
    w = types.SimpleNamespace(steps=10, wall_s=2.0, step_ms=[float(i) for i in range(1, 11)])
    c = ctx(window=w, windows=[(8, 10, 2.0), (8, 10, 4.0)])
    assert read("env_steps_per_s", c) == pytest.approx(8 * 10 / 2.0)
    assert read("step_ms_p90", c) == pytest.approx(np.percentile(range(1, 11), 90))
    assert read("step_ms_p90", c) == pytest.approx(9.1)
    assert read("setup_s", c) == 1.5


def test_roofline_share_from_the_solves_own_inputs():
    from portbench.harness.roofline import sphere_world_bound
    from test_isaacgym_tpu_torch.ops import sphere_world as sw

    F = 64
    spec = sw.SphereWorldSpec(
        shape_idx=np.arange(F, dtype=np.int32), free_idx=np.arange(F, dtype=np.int32),
        body_slot=np.arange(F, dtype=np.int32), allow=np.triu(np.ones((F, F), bool), 1),
        has_ground=True, plane_n=np.array([0, 0, 1], np.float32), plane_d=0.0,
        plane_friction=1.0, plane_restitution=0.0)
    g = torch.Generator().manual_seed(0)
    pos = torch.rand((1, F, 3), generator=g)
    f = torch.rand((1, F), generator=g)
    args = (spec, pos, pos, pos, f * 0.1 + 0.1, f, f, f, f, 1 / 60, 4, 0.02, 0.001, 0.2)
    least_ms, by, active = sphere_world_bound(args)
    assert by == "operations" and active > 0
    trace = Trace([X("user_annotation", WINDOW_SPAN, 0, 100),
                   X("kernel", "(anonymous namespace)::sw_broadphase(World)", 0, 1),
                   X("kernel", "(anonymous namespace)::sw_sweeps(World)", 1, 3),
                   X("kernel", "elementwise", 5, 50)])
    c = ctx(trace=trace, captured={"sphere_world": [args, args]})
    assert read("sphere_world.roofline_pct", c) == pytest.approx(100 * 2 * least_ms * 1e3 / 4)

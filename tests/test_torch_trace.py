"""The port's spans and set-up stages (utils/trace.py).

  * with no profiler running, `span` hands back one shared null context and
    never opens a record_function;
  * under torch.profiler, one step of an 8-env FrankaOscEnv and of a small
    BallsEnv writes the spans of utils/trace.py's table to the chrome trace,
    each inside the span that calls it;
  * a few steps give the same bits with the profiler on and off;
  * building an env adds to `stage_s["setup.build"]` and
    `stage_s["setup.finalize"]`.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_isaacgym_tpu_torch.utils import trace

# each span -> the spans it may lie directly inside (None: no span)
NESTING = {
    "franka": {
        "control.osc": {None},
        "control.osc.jacobian": {"control.osc"},
        "control.osc.mass_matrix": {"control.osc"},
        "sim.step": {None},
        "sim.phase_a": {"sim.step"},
        "sim.phase_b": {"sim.step"},
        "sim.phase_d": {"sim.step"},
        "sim.refresh": {"sim.step"},
        "fk": {"sim.phase_a", "sim.refresh"},
        "crba": {"sim.phase_a", "control.osc.mass_matrix"},
        "rnea": {"sim.phase_a"},
        "chol": {"sim.phase_a", "control.osc"},
    },
    "balls": {
        "sim.step": {None},
        "sim.phase_a": {"sim.step"},
        "sim.phase_b": {"sim.step"},
        "sim.phase_c": {"sim.step"},
        "sim.phase_d": {"sim.step"},
        "sim.refresh": {"sim.step"},
        "contact.sphere_world": {"sim.phase_c"},
        "chol": {"sim.phase_b"},
    },
}


def _build(kind):
    if kind == "franka":
        from test_isaacgym_tpu_torch.envs.franka import FrankaOscEnv

        return FrankaOscEnv(num_envs=8, device="cpu")
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv

    return BallsEnv(pyramids=3, device="cpu")  # 90 balls: the sphere world


@pytest.fixture(scope="module", params=sorted(NESTING))
def built(request):
    """(kind, env, the stage seconds its build added)."""
    before = dict(trace.stage_s)
    env = _build(request.param)
    added = {k: v - before.get(k, 0.0) for k, v in trace.stage_s.items()}
    return request.param, env, added


def _steps(env, state, n):
    run = env.rollout_fn(1)
    for _ in range(n):
        state = run(state)
    return state


def test_span_is_a_shared_null_context_with_no_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = trace.span("sim.step")
    assert all(trace.span(n) is first for n in ("fk", "chol", "sim.step"))
    with first:
        with trace.span("fk"):
            pass


def _user_spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _parent(spans, child):
    """The name of the shortest span that holds `child`, or None."""
    name, s, e = child
    holders = [(b - a, n) for n, a, b in spans
               if (n, a, b) != child and a <= s and e <= b and (b - a) > (e - s)]
    return min(holders)[1] if holders else None


def test_one_profiled_step_has_the_spans_nested_as_called(built, tmp_path):
    kind, env, _ = built
    state = env.sim.state
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(env, state, 1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = _user_spans(path)
    want = NESTING[kind]
    assert {n for n, _, _ in spans} == set(want)
    for child in spans:
        assert _parent(spans, child) in want[child[0]], (child[0], _parent(spans, child))


def test_the_profiler_leaves_the_state_bitwise_unchanged(built):
    _, env, _ = built
    start = env.sim.state
    plain = _steps(env, start, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _steps(env, start, 3)
    for name, a, b in zip(plain._fields, plain, profiled):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name


def test_building_an_env_times_its_stages(built):
    _, _, added = built
    assert added.get("setup.build", 0.0) > 0.0
    assert added.get("setup.finalize", 0.0) > 0.0

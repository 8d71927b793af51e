"""The soft solve's spans and set-up stage (utils/trace.py) on the soft_body
scene (envs/soft_body.py, the reference's examples/soft_body.py) at 4 envs:

  * one profiled step has 3 `sim.soft` spans inside `sim.step`, one a
    substep, each holding exactly one `soft.iterations`;
  * the profiled step's state is bitwise the unprofiled step's;
  * building the scene adds to `stage_s["setup.soft"]`.
"""
import json

import torch
from torch.profiler import ProfilerActivity, profile

from test_isaacgym_tpu_torch.envs import soft_body as sb
from test_isaacgym_tpu_torch.utils import trace

ENVS = 4


def _user_spans(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(spans, name, outer):
    """The spans of `name` that lie within the span `outer`."""
    _, a, b = outer
    return [s for s in spans if s[0] == name and a <= s[1] and s[2] <= b]


def _step(sim, state):
    return sim.stepper.rollout(state, sim.actions, sim.params, 1)


def test_one_profiled_step_has_a_soft_span_a_substep_holding_its_iterations(tmp_path):
    sim = sb.soft_body_sim(ENVS, device="cpu")
    plain = _step(sim, sim.state)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiled = _step(sim, sim.state)
    spans = _user_spans(prof, tmp_path)
    steps = [s for s in spans if s[0] == "sim.step"]
    soft = [s for s in spans if s[0] == "sim.soft"]
    assert len(steps) == 1 and len(soft) == sim.stepper.substeps == 3
    assert _inside(spans, "sim.soft", steps[0]) == soft
    for s in soft:
        assert len(_inside(spans, "soft.iterations", s)) == 1
    assert len([s for s in spans if s[0] == "soft.iterations"]) == 3
    for name, a, b in zip(plain._fields, plain, profiled):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name


def test_building_the_scene_times_the_soft_set_up():
    before = trace.stage_s.get("setup.soft", 0.0)
    sb.soft_body_sim(ENVS, device="cpu")
    assert trace.stage_s.get("setup.soft", 0.0) > before

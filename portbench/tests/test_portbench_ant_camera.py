"""The Ant camera cell (ant_camera-4096-frames) on the CPU at a few envs:

  * the plain reference (reference/ant_camera.py) reproduces the JAX
    package's render() frame of the Ant golden (ant_standin.npz) by
    chip_smoke.py's rule, and imports nothing of the port or the JAX
    package;
  * its float32 run rounds as the program: the images are the same bits;
  * the driver's program side agrees with it under the harness's rule at
    the reset pose and at random DOF angles, the TF32 control and planted
    faults do not;
  * the cell's files and metrics are found by name, the readers read the
    port's render spans and stage (nothing where the program has none), and
    the bound's counts are the hand count and scale linearly;
  * on the card (marked `cuda`), a frame of the driver's path makes no host
    sync.
"""
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from conftest import ROOT
from helpers import run, small_spec
from portbench.harness import checks, runner, spec as specmod
from portbench.harness.render_bound import frame_bytes, frame_ops, render_bound
from portbench.harness.trace import WINDOW_SPAN, Trace

CELL = "ant_camera-4096-frames"
METRICS = ("render.host_ms", "render.device_ms", "render.launches", "render.roofline_pct",
           "setup.render_s")
FRAME_SHARE = 0.01  # chip_smoke.py's rule for render() against a JAX frame
SEED = 2**31 + 13


def spec_at(envs=4, width=16, height=12, **traffic):
    s = small_spec(CELL, envs=envs, **traffic)
    s.config["camera"] = dict(s.config["camera"], width=width, height=height)
    return s


def test_the_reference_reproduces_the_jax_frame():
    """render()'s 320 x 240 frame of env 0 after the golden's last step
    (tools/make_rl_goldens.py), each shape's index + 1 its segmentation id:
    the Ant posed from obs[horizon - 1] (root height, quaternion, DOF
    angles), the camera at the root + (-1.5, -1.5, 1) looking at the root.
    The root's x and y do not show: the camera follows it over a uniform
    ground."""
    from portbench.reference.ant_camera import AntCameras

    g = np.load(os.path.join(ROOT, "test_isaacgym_tpu_torch", "assets", "data",
                             "ant_standin.npz"))
    obs = torch.as_tensor(g["obs"][int(g["horizon"]) - 1][:1], dtype=torch.float64)
    cfg = dict(specmod.load(CELL).config, num_envs=1)
    cams = AntCameras(cfg, ROOT, obs[:, 11:19], "cpu")
    root = torch.cat([torch.zeros(1, 2, dtype=torch.float64), obs[:, :1]], -1)
    body_pos, body_quat = cams.pose(root, obs[:, 1:5], obs[:, 11:19])
    eye = root + torch.tensor([-1.5, -1.5, 1.0], dtype=torch.float64)
    f64 = dict(dtype=torch.float64)
    light = torch.tensor([-0.3, -0.3, -0.9], **f64)
    rgba, _, seg = cams.render(
        body_pos, body_quat, eye, eye, root, torch.tensor(cams.ant.shape_color, **f64)[None],
        torch.arange(1, 14), torch.full((3,), 0.8, **f64), torch.full((3,), 0.25, **f64),
        light / torch.linalg.vector_norm(light), 320, 240, 100.0, 90.0)
    rgb = rgba[0, ..., :3].numpy().astype(np.int32)
    seg_bad = seg[0].numpy() != g["frame_seg"]
    col_bad = np.abs(rgb - g["frame"].astype(np.int32)).max(-1) > 1
    assert (seg_bad | col_bad).mean() <= FRAME_SHARE, (seg_bad.mean(), col_bad.mean())
    assert len(np.unique(g["frame_seg"])) > 5  # the torso and legs are in view


def test_the_reference_imports_nothing_of_the_port():
    code = (
        "import sys, portbench.reference.ant_camera\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'test_isaacgym_tpu', 'test_isaacgym_tpu_torch'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def cells(spec, seed, dof_spread=0.0):
    """(driver, inputs, program cell, reference cell) of the spec, the
    scene posed at DOF angles uniform within +-dof_spread rad."""
    driver = specmod.load_module(spec.driver_path, "portbench_drivers")
    inputs = driver.inputs(spec.config, spec.traffic, seed, "cpu")
    g = torch.Generator().manual_seed(seed % 2**63)
    inputs["dof_pos"] = ((2 * torch.rand(inputs["dof_pos"].shape, generator=g) - 1)
                         * dof_spread).numpy()
    return (driver, inputs, driver.build(spec.config, spec.traffic, inputs, "cpu"),
            driver.reference(spec.config, spec.traffic, inputs, "cpu"))


@pytest.mark.parametrize("dof_spread", [0.0, 0.8], ids=["reset_pose", "random_dofs"])
def test_the_reference_in_float32_rounds_as_the_program(dof_spread):
    """The harness's float32 witness renders the program's frame bit for
    bit, so it leaves out exactly the pixels where float32 flips a grazing
    ray or a tie between touching shapes."""
    _, _, prog, ref = cells(spec_at(envs=8, width=64, height=48), SEED, dof_spread)
    frame = prog.starts[0]
    _, out = prog.step(frame)
    _, out32 = ref.step(prog.handoff(frame), torch.float32)
    for name, a, b in zip(("rgba", "depth", "seg"), out, out32):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("dof_spread", [0.0, 0.8], ids=["reset_pose", "random_dofs"])
def test_the_program_agrees_with_the_reference(dof_spread):
    """Three frames of 4 envs at 16 x 12, each held to the reference under
    the harness's rule (runner.compare: the witnesses, the limits)."""
    spec = spec_at()
    driver, inputs, prog, _ = cells(spec, SEED, dof_spread)
    state, kept = prog.starts[0], {}
    for k in range(3):
        after, out = prog.step(state)
        kept[k] = (prog.handoff(state), prog.fields(after, out))
        state = after
    starts = [prog.fields(prog.starts[0], None)]
    numbers, failed = runner.compare(driver, spec, inputs, starts, kept, SEED, "cpu", 0, 1)
    correct, compared = checks.verdict(numbers, spec.limits)
    assert correct and failed == 0, compared


def test_a_run_is_correct_and_reports_its_metrics():
    r = run(spec_at(trace_from=0, trace_steps=1), seconds=3.0, trace=1)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    # on the CPU no device time: the device readers are left out
    assert {"render.host_ms", "render.launches", "setup.render_s"} <= set(r["metrics"])
    assert r["metrics"]["setup.render_s"]["value"] > 0


def test_the_tf32_control_is_not_correct():
    """The start rounded to TF32 moves every shape by ~1e-4 m; in a frame
    TF32 products move a ray by ~5e-4 rad, which flips silhouette pixels
    that no witness leaves out."""
    r = run(spec_at(width=64, height=48), seconds=1.0, impl="control")
    assert not r["correct"], r["checks"]
    assert r["checks"]["start_gap"]["value"] > r["checks"]["start_gap"]["limit"]
    assert r["checks"]["step_gap"]["value"] > r["checks"]["step_gap"]["limit"]


def _capsule_twice_as_long(monkeypatch, raster):
    """The left front leg's capsule (shape 5) drawn at twice its
    half-length."""
    render = raster.render_camera_batch

    def faulty(cp, cq, sp, sq, size, *a, **k):
        size = size.clone()
        size[:, 5, 1] *= 2.0
        return render(cp, cq, sp, sq, size, *a, **k)

    monkeypatch.setattr(raster, "render_camera_batch", faulty)


def _light_from_below(monkeypatch, raster):
    """The light's direction with its sign flipped."""
    render = raster.render_camera_batch

    def faulty(cp, cq, sp, sq, size, kind, color, seg, ground, light_dir, *a, **k):
        return render(cp, cq, sp, sq, size, kind, color, seg, ground, -light_dir, *a, **k)

    monkeypatch.setattr(raster, "render_camera_batch", faulty)


@pytest.mark.parametrize("fault", [_capsule_twice_as_long, _light_from_below],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    from test_isaacgym_tpu_torch.render import raster

    fault(monkeypatch, raster)
    r = run(spec_at(width=64, height=48), seconds=1.0)
    assert not r["correct"], r["checks"]
    assert r["checks"]["step_gap"]["value"] > r["checks"]["step_gap"]["limit"]


def test_the_cell_is_found_by_name():
    s = specmod.load(CELL)
    assert s.config_name == "ant_camera-4096" and s.chips == 1 and s.traffic_name == "frames"
    assert s.driver_path.name == "ant_camera-4096.py" and s.driver_path.exists()
    assert set(s.limits) == {"start_gap", "step_gap"}
    assert [m["name"] for m in s.per_layer] == list(METRICS)
    assert [m["name"] for m in s.end_to_end] == ["env_steps_per_s", "step_ms_p90", "setup_s"]
    for m in s.per_layer + s.end_to_end:
        assert callable(specmod.metric_reader(m["name"]))


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


WORK = {"envs": 4096, "width": 64, "height": 48, "spheres": 1, "capsules": 12, "ground": 1}


def _ctx(trace, work=WORK):
    return types.SimpleNamespace(trace=trace, profiled_steps=2,
                                 counts={"render.work": work} if work else {}, captured={},
                                 envs=4096, window=None, windows=[], setup_s=1.0)


def test_the_readers_on_a_synthetic_trace():
    """Two frames: render.poses at 0-5 and 50-55, render at 10-40 and 60-90
    holding render.primitives; launches 1 and 2 inside the render spans (2
    carried by two kernels), 3 in render.poses, 4 outside any."""
    from test_isaacgym_tpu_torch.utils import trace

    ev = [X("user_annotation", WINDOW_SPAN, 0, 100)]
    for t0 in (0, 50):
        ev += [X("user_annotation", "render.poses", t0, 5),
               X("user_annotation", "render", t0 + 10, 30),
               X("user_annotation", "render.primitives", t0 + 15, 10)]
    ev += [X("cuda_runtime", "cudaLaunchKernel", 16, 1, correlation=1),
           X("cuda_runtime", "cudaLaunchKernel", 70, 1, correlation=2),
           X("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=3),
           X("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=4),
           X("kernel", "k1", 20, 300, correlation=1),
           X("kernel", "k2a", 320, 200, correlation=2), X("kernel", "k2b", 520, 100, correlation=2),
           X("kernel", "k3", 620, 1000, correlation=3), X("kernel", "k4", 1620, 50, correlation=4)]
    c = _ctx(Trace(ev))
    read = {m: specmod.metric_reader(m)(c) for m in METRICS}
    assert read["render.host_ms"] == pytest.approx(0.030)
    assert read["render.device_ms"] == pytest.approx(0.300)
    assert read["render.launches"] == 1
    assert read["render.roofline_pct"] == pytest.approx(100 * render_bound(**WORK)[0] / 0.300)
    assert read["setup.render_s"] == trace.stage_s.get("setup.render")


def test_the_readers_without_the_ports_spans(monkeypatch):
    """As on a program without the render spans and stage: nothing, no
    error."""
    from test_isaacgym_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "stage_s", {})
    ev = [X("user_annotation", WINDOW_SPAN, 0, 110),
          X("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
          X("kernel", "k1", 14, 300, correlation=1)]
    c = _ctx(Trace(ev))
    for m in METRICS:
        assert specmod.metric_reader(m)(c) is None, m


def test_the_bound_is_the_hand_count_and_scales_linearly():
    one = dict(envs=1, width=1, height=1, spheres=1, capsules=12, ground=1)
    per_env = 39 + 13 * 88 + 7 + 12 * 21
    per_ray = 26 + 13 * 17 + 14 + 12 * 54 + 16 + 80 + 16
    assert frame_ops(**one) == per_env + per_ray
    assert frame_bytes(**one) == 13 * 56 + 24 + 12
    for size, times in (("envs", 4096), ("width", 64), ("height", 48)):
        big = dict(one, **{size: times})
        if size == "envs":
            assert frame_ops(**big) == times * frame_ops(**one)
            assert frame_bytes(**big) == times * frame_bytes(**one)
        else:  # the per-ray part grows, the per-env part stays
            assert frame_ops(**big) - per_env == times * per_ray
            assert frame_bytes(**big) - (13 * 56 + 24) == times * 12
    least, bound = render_bound(**WORK)
    assert bound == "operations" and 0.1 < least < 0.3  # ms a frame at the cell's width


@pytest.mark.cuda
def test_a_frame_of_the_cell_makes_no_host_sync(card):
    """One frame of the driver's path at 64 envs (the cell's camera) under
    torch.cuda.set_sync_debug_mode("error"), as chip_smoke.py's
    assert_sync_free runs a step."""
    spec = small_spec(CELL, envs=64)
    driver = specmod.load_module(spec.driver_path, "portbench_drivers")
    inputs = driver.inputs(spec.config, spec.traffic, SEED, card)
    cell = driver.build(spec.config, spec.traffic, inputs, card)
    frame, _ = cell.step(cell.starts[0])  # warm: the allocator and library handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        frame, out = cell.step(frame)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out[0].shape == (64, 48, 64, 4) and time.perf_counter() - t < 60

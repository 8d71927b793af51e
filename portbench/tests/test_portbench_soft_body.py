"""The soft-body press cell (soft_body-1024-press) on the CPU at 4 envs:

  * the plain reference (reference/soft_body.py) reproduces the JAX
    package's recorded soft_pos of the soft_body scene (soft_body_standin.npz,
    every recorded step) at the records' own rule, and imports nothing of
    the port or the JAX package;
  * the driver's program side agrees with it within the cell's limits, the
    TF32 control and planted faults do not;
  * the cell's files and metrics are found by name, the metrics read the
    port's spans and stage (nothing where the program has none), and the
    XPBD bound's counts scale linearly in each of their sizes.
"""
import json
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import ROOT
from helpers import run, small_spec
from portbench.harness import spec as specmod
from portbench.harness.trace import WINDOW_SPAN, Trace
from portbench.harness.xpbd_bound import substep_bytes, substep_ops, xpbd_bound

CELL = "soft_body-1024-press"
TOL = 1e-4  # the JAX records' own rule: max |err| <= TOL * max(|record|, 1)
METRICS = ("sim.soft.host_ms", "soft.device_ms", "soft.launches", "soft.roofline_pct",
           "setup.soft_s")


def config(**kw):
    with open(os.path.join(ROOT, "portbench", "configs", "soft_body-1024.json")) as f:
        return dict(json.load(f), **kw)


def example_materials(n, cfg):
    """examples/soft_body.py's draws (random.seed(7), env by env: Young's,
    Poisson's, damping), Poisson's ratio clipped as the configuration says."""
    m = cfg["materials"]
    rng, out = random.Random(7), []
    for _ in range(n):
        e = rng.uniform(m["youngs"] * m["youngs_range"][0], m["youngs"] * m["youngs_range"][1])
        nu = min(rng.uniform(m["poissons"] * m["poissons_range"][0],
                             m["poissons"] * m["poissons_range"][1]), m["poissons_max"])
        out.append((e, nu, rng.uniform(*m["damping_sqrt"]) ** 2))
    return tuple(np.asarray(c, np.float32) for c in zip(*out))


def test_the_reference_reproduces_the_jax_record():
    """The JAX package's soft_body scene, 4 envs with the example's
    materials, op by op: soft_pos at every recorded step
    (soft_body_standin.npz, made by tests/test_torch_soft.py)."""
    from portbench.reference.soft_body import SoftPress

    cfg = config()
    rec = np.load(os.path.join(ROOT, cfg["asset_root"], "..", "soft_body_standin.npz"))
    n = int(rec["num_envs"])
    press = SoftPress(dict(cfg, num_envs=n), ROOT, example_materials(n, cfg), "cpu")
    s = press.start()
    for k, want in enumerate(rec["soft_pos"]):
        err = float(np.abs(s.soft_pos.numpy() - want).max())
        assert err <= TOL * max(float(np.abs(want).max()), 1.0), (k, err)
        s, _ = press.step(s)


def test_the_reference_imports_nothing_of_the_port():
    code = (
        "import sys, portbench.reference.soft_body\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'test_isaacgym_tpu', 'test_isaacgym_tpu_torch'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_the_program_agrees_with_the_reference_and_reports_its_metrics():
    r = run(small_spec(CELL, trace_from=0, trace_steps=1), seconds=6.0, trace=1)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 4
    # on the CPU no device time: the device readers are left out
    assert {"sim.soft.host_ms", "setup.soft_s", "soft.launches"} <= set(r["metrics"])
    assert r["metrics"]["setup.soft_s"]["value"] > 0


def test_the_tf32_control_is_not_correct():
    r = run(small_spec(CELL), seconds=3.0, impl="control")
    assert not r["correct"], r["checks"]
    # at 4 envs the origins lie within 8.5 m, where TF32 rounds the start by
    # ~2 mm: start_gap fails; at the cell's width step_gap fails as well
    assert r["checks"]["start_gap"]["value"] > r["checks"]["start_gap"]["limit"]


def _youngs_times_100_in_env_0(monkeypatch):
    """The program's material read gives env 0 a hundred times its Young's
    modulus. A step sees a material little: at this seed a tenfold modulus
    reads 0.003-0.011 a step, about the limit, a doubled one 0.001, one
    XPBD iteration dropped less than float32's own rounding at the cell's
    width (PERF.md section 6)."""
    soft = sys.modules["test_isaacgym_tpu_torch.physics.soft"]
    materials = soft.SoftStepper.materials

    def faulty(self, params, h):
        e = params.soft_youngs.clone()
        e[0] *= 100.0
        return materials(self, params._replace(soft_youngs=e), h)

    monkeypatch.setattr(soft.SoftStepper, "materials", faulty)


def _env_0_moved(monkeypatch):
    """The soft substep's answer for env 0 moved by 5 cm along x."""
    soft = sys.modules["test_isaacgym_tpu_torch.physics.soft"]
    substep = soft.SoftStepper.substep

    def faulty(self, *a):
        p, v = substep(self, *a)
        p = p.clone()
        p[0, :, 0] += 0.05
        return p, v

    monkeypatch.setattr(soft.SoftStepper, "substep", faulty)


@pytest.mark.parametrize("fault", [_youngs_times_100_in_env_0, _env_0_moved],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    import test_isaacgym_tpu_torch.physics.soft  # noqa: F401

    fault(monkeypatch)
    r = run(small_spec(CELL), seconds=5.0)
    assert not r["correct"], r["checks"]
    assert r["checks"]["step_gap"]["value"] > r["checks"]["step_gap"]["limit"]


def test_the_cell_is_found_by_name():
    s = specmod.load(CELL)
    assert s.config_name == "soft_body-1024" and s.chips == 1 and s.traffic_name == "press"
    assert s.driver_path.name == "soft_body-1024.py" and s.driver_path.exists()
    assert set(s.limits) == {"start_gap", "step_gap"}
    assert [m["name"] for m in s.per_layer] == list(METRICS)
    for m in s.per_layer + s.end_to_end:
        assert callable(specmod.metric_reader(m["name"]))


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _ctx(trace, work=None):
    return types.SimpleNamespace(trace=trace, profiled_steps=1, counts={"soft.work": work} if work
                                 else {}, captured={}, envs=1024, window=None, windows=[],
                                 setup_s=1.0)


WORK = {"envs": 1024, "verts": 195, "tets": 570, "colliders": 1, "iterations": 80, "substeps": 3}


def test_the_readers_on_a_synthetic_trace():
    """One step: sim.step at 0-100 holding sim.soft at 10-30 and 50-70;
    launches 1 and 2 inside the soft spans (2 carried by two kernels), 3
    inside the step only."""
    ev = [X("user_annotation", WINDOW_SPAN, 0, 110), X("user_annotation", "sim.step", 0, 100),
          X("user_annotation", "sim.soft", 10, 20), X("user_annotation", "sim.soft", 50, 20),
          X("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
          X("cuda_runtime", "cudaLaunchKernel", 55, 1, correlation=2),
          X("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=3),
          X("kernel", "k1", 14, 300, correlation=1),
          X("kernel", "k2a", 320, 200, correlation=2), X("kernel", "k2b", 520, 100, correlation=2),
          X("kernel", "k3", 620, 1000, correlation=3)]
    c = _ctx(Trace(ev), WORK)
    read = {m: specmod.metric_reader(m)(c) for m in METRICS}
    assert read["sim.soft.host_ms"] == pytest.approx(0.040)
    assert read["soft.device_ms"] == pytest.approx(0.600)
    assert read["soft.launches"] == 2
    assert read["soft.roofline_pct"] == pytest.approx(100 * xpbd_bound(**WORK)[0] / 0.600)


def test_the_readers_without_the_ports_spans():
    """As on a program without the sim.soft span: nothing, no error."""
    ev = [X("user_annotation", WINDOW_SPAN, 0, 110), X("user_annotation", "sim.step", 0, 100),
          X("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
          X("kernel", "k1", 14, 300, correlation=1)]
    c = _ctx(Trace(ev), WORK)
    for m in METRICS[:4]:
        assert specmod.metric_reader(m)(c) is None, m


@pytest.mark.parametrize("size", ["envs", "tets", "iterations", "substeps"])
def test_the_bound_scales_linearly(size):
    per = {k: v for k, v in WORK.items() if k != "substeps"}
    base_ops = WORK["substeps"] * substep_ops(**per)
    big = dict(WORK, **{size: 2 * WORK[size]})
    big_per = {k: v for k, v in big.items() if k != "substeps"}
    ops = big["substeps"] * substep_ops(**big_per)
    if size in ("envs", "substeps"):
        assert ops == 2 * base_ops
    else:  # the per-iteration or per-tet part doubles, the rest stays
        assert base_ops < ops < 2 * base_ops
        grown = {"tets": lambda w: w["envs"] * w["tets"] * (w["iterations"] * 347 + 10),
                 "iterations": lambda w: w["envs"] * w["iterations"] * (
                     w["tets"] * 347 + w["verts"] * (14 + 55 * w["colliders"]))}[size]
        assert ops - base_ops == WORK["substeps"] * (grown(big) - grown(WORK))
    nbytes = {k: v for k, v in per.items() if k != "iterations"}
    if size == "envs":
        fixed = substep_bytes(**dict(nbytes, envs=0))
        assert substep_bytes(**dict(nbytes, envs=2048)) - fixed == 2 * (
            substep_bytes(**nbytes) - fixed)
    least, bound = xpbd_bound(**WORK)
    assert bound == "operations" and 0.5 < least < 1.0  # ms a step at the cell's width

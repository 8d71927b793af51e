"""The plain references: each held to the JAX package's own recorded runs
(loaded as data), each driver's program side agreeing with its reference
at a tiny width on the CPU, and the lower-precision control, put in the
program's place, failing the same comparison."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT
from helpers import run, small_spec

CELLS = ["franka-4096-track", "balls-1080-pile"]
TOL = 1e-4  # the JAX records' own rule: max |err| <= TOL * max(|record|, 1)


def config(name, **kw):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return dict(json.load(f), **kw)


def gap(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1.0)


def test_the_franka_reference_reproduces_the_jax_record():
    """The JAX package's FrankaOscEnv, 8 envs of the stand-in from the
    default pose, every 10 steps to 50 (franka_osc_standin.npz, made by
    tests/test_torch_franka.py)."""
    from portbench.reference.franka import FrankaTrack

    cfg = config("franka-4096", num_envs=8)
    rec = np.load(os.path.join(ROOT, cfg["asset_root"], "franka_osc_standin.npz"))
    arm = FrankaTrack(cfg, os.path.join(ROOT, cfg["asset_root"], cfg["urdf"]), "cpu")
    origins = np.array([[2.0 * (i % 2), 2.0 * (i // 2), 0.0] for i in range(8)])  # 2 envs a row
    s = arm.start(torch.zeros(8, 7))
    for k in range(rec["dof_pos"].shape[0]):
        f = arm.fields(s, None)
        assert gap(f["hand_pos"].numpy() + origins, rec["hand_pos"][k]) < TOL, k
        assert gap(f["dof_pos"].numpy(), rec["dof_pos"][k]) < TOL, k
        for _ in range(10):
            s, _ = arm.step(s)
    assert int(s.steps) == 60


def test_the_balls_reference_reproduces_the_jax_record():
    """The JAX package's BallsEnv, 4 pyramids (120 balls) from seed 17,
    every 10 steps to 120 (tests/goldens/balls_drop.npz)."""
    from portbench.reference.balls import BallPile

    rec = np.load(os.path.join(ROOT, "tests", "goldens", "balls_drop.npz"))["pos"]
    pile = BallPile(config("balls-1080", pyramids=4), 17, "cpu")
    s = pile.start()
    for k in range(rec.shape[0]):
        assert gap(s.root_pos[0].numpy(), rec[k]) < TOL, k
        for _ in range(10):
            s, _ = pile.step(s)


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_with_the_reference(workload):
    seconds = 2.0 if workload == "balls-1080-pile" else 1.0
    r = run(small_spec(workload, episode_steps=3), seconds=seconds)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["checks"]) == {"start_gap", "step_gap"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_is_not_correct(workload):
    # the track's kept steps reach past its first hundred, where the
    # control's trajectory has left the start's large efforts
    track = workload == "franka-4096-track"
    r = run(small_spec(workload, **({"check_within": 200} if track else {})),
            seconds=10.0 if track else 1.0, impl="control")
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_references_import_nothing_of_the_port():
    code = (
        "import sys, portbench.reference.franka, portbench.reference.balls, "
        "portbench.reference.precision\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'test_isaacgym_tpu', 'test_isaacgym_tpu_torch'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)

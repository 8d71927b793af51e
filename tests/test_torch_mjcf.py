"""Port parity: the MJCF importer (assets/mjcf.py) against the JAX package.

MJCF texts written here go through both importers, and every link, geom
and joint field must be equal: default classes and their cascade (`class`,
`childclass`), `angle="degree|radian"` and `eulerseq`, body frames from
quat / euler / axisangle / zaxis, `fromto` capsules, cylinders and boxes,
spheres, boxes, ellipsoids, a `<freejoint>` root and a `<joint type="free">`
one, hinge, slide and ball joints with range / limited / damping /
stiffness / armature / frictionloss, a body with two joints (its massless
intermediate link), `<inertial>` with diaginertia or fullinertia, and
density-based mass otherwise. The committed Ant stand-in has the 9 bodies,
13 shapes and 8 DOFs of the reference's nv_ant.xml and a floating base, and
a few steps of it agree with the JAX package at 1e-4 * max(|ref|, 1).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_isaacgym_tpu  # noqa: F401  (CPU platform before jax init)
from test_isaacgym_tpu.assets import mjcf as jmjcf
from test_isaacgym_tpu.core.config import PlaneParams as JaxPlane
from test_isaacgym_tpu.core.config import SimParams as JaxSimParams
from test_isaacgym_tpu.core.scene import SceneBuilder as JaxBuilder
from test_isaacgym_tpu.core.sim import Simulator as JaxSimulator
from test_isaacgym_tpu_torch.assets import load_mjcf
from test_isaacgym_tpu_torch.core.config import PlaneParams, SimParams
from test_isaacgym_tpu_torch.core.scene import SceneBuilder
from test_isaacgym_tpu_torch.core.sim import Simulator
from test_isaacgym_tpu_torch.core.state import to_numpy
from test_isaacgym_tpu_torch.envs.rl_env import ASSET_ROOT

ANT = "mjcf/nv_ant.xml"
TOL = 1e-4

CLASSES = """<mujoco model="zoo">
  <compiler angle="{angle}" eulerseq="{seq}"/>
  <default>
    <joint damping="0.2" armature="0.02" limited="true"/>
    <geom density="300" friction="0.9 0.1 0.1" rgba="0.2 0.4 0.6 1"/>
    <default class="soft">
      <joint stiffness="5" frictionloss="0.3"/>
      <geom density="50" rgba="0.9 0.1 0.1 1"/>
      <default class="softer">
        <joint damping="0.05"/>
      </default>
    </default>
  </default>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="root" pos="0.1 0.2 1.0" euler="{e1}">
      {root_joint}
      <geom type="sphere" size="0.2"/>
      <geom type="capsule" fromto="0 0 0 0.3 0.1 -0.2" size="0.05"/>
      <body name="a" pos="0.3 0 0" quat="0.9238795 0 0.3826834 0" childclass="soft">
        <joint name="ja" type="hinge" axis="0 1 0" range="{r1}"/>
        <geom type="box" size="0.1 0.05 0.02" pos="0.1 0 0" euler="{e2}"/>
        <inertial pos="0.05 0 0" mass="0.7" diaginertia="0.01 0.02 0.03"/>
        <body name="b" pos="0.2 0 0" axisangle="0 0 1 {aa}">
          <joint name="jb1" type="slide" axis="1 0 0" range="-0.1 0.2" class="softer"/>
          <joint name="jb2" type="hinge" axis="0 0 1" pos="0.01 0 0"/>
          <geom type="cylinder" size="0.04 0.1" class="softer"/>
          <geom type="cylinder" fromto="0 0 0 0 0.2 0" size="0.03"/>
          <inertial pos="0 0 0" mass="0.3" fullinertia="0.003 0.004 0.005 0.0001 0.0002 0.0003"/>
        </body>
      </body>
      <body name="c" pos="-0.3 0 0" zaxis="1 1 0">
        <joint name="jc" type="ball" limited="false"/>
        <geom type="ellipsoid" size="0.05 0.08 0.1"/>
        <geom type="box" fromto="0 0 0 0 0 0.3" size="0.02 0.04"/>
        <body name="d" pos="0 0 0.3" zaxis="0 0 -1">
          <joint name="jd" type="hinge" axis="1 0 0"/>
          <geom type="capsule" size="0.03 0.07" quat="0.7071068 0.7071068 0 0"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""
VARIANTS = {
    "degree_freejoint": dict(angle="degree", seq="xyz", e1="10 20 30", e2="0 45 0", r1="-30 60",
                             aa="30", root_joint='<freejoint name="root"/>'),
    "radian_typefree": dict(angle="radian", seq="zyx", e1="0.1 0.2 0.3", e2="0 0.8 0",
                            r1="-0.5 1.0", aa="0.5", root_joint='<joint type="free"/>'),
    "fixed_root": dict(angle="degree", seq="xzy", e1="0 0 0", e2="10 0 5", r1="-10 10", aa="90",
                       root_joint=""),
}


def _load_both(tmp_path, text, name="m.xml"):
    (tmp_path / name).write_text(text)
    return (load_mjcf(str(tmp_path), name),
            jmjcf.load_mjcf(str(tmp_path), name))


def _equal(got, want, what):
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)
    elif dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, what
        for f in dataclasses.fields(want):
            _equal(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
    else:
        assert got == want, f"{what}: {got!r} != {want!r}"


def assert_assets_equal(got, want):
    assert got.name == want.name and got.fix_base_link == want.fix_base_link
    assert got.default_dof_drive_mode == want.default_dof_drive_mode
    assert len(got.links) == len(want.links)
    for i, (gl, wl) in enumerate(zip(got.links, want.links)):
        _equal(gl, wl, f"links[{i}] ({wl.name})")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mjcf_text_like_jax(tmp_path, variant):
    got, want = _load_both(tmp_path, CLASSES.format(**VARIANTS[variant]))
    assert_assets_equal(got, want)
    names = [l.name for l in got.links]
    # the two-joint body expands into an intermediate link before "b"
    assert names.index("b__j0") == names.index("b") - 1
    b0, b = got.links[names.index("b__j0")], got.links[names.index("b")]
    assert b0.joint.name == "jb1" and b0.joint.damping == pytest.approx(0.05)  # class softer
    assert b.joint.name == "jb2" and b.joint.damping == pytest.approx(0.2)  # childclass soft
    assert b.mass == pytest.approx(0.3)
    a = got.links[names.index("a")]
    assert a.joint.stiffness == 5.0 and a.joint.friction == pytest.approx(0.3)
    assert a.geoms[0].density == 50.0 and a.geoms[0].color == pytest.approx((0.9, 0.1, 0.1))
    assert got.fix_base_link == (variant == "fixed_root")


def test_ant_standin_structure():
    got = load_mjcf(ASSET_ROOT, ANT)
    want = jmjcf.load_mjcf(ASSET_ROOT, ANT)
    assert_assets_equal(got, want)
    assert len(got.links) == 9
    assert sum(len(l.geoms) for l in got.links) == 13
    assert sum(1 for l in got.links if l.joint is not None and l.joint.jtype != 0) == 8
    assert not got.fix_base_link and got.links[0].joint is None  # floating base
    hips = [l.joint for l in got.links if l.joint is not None and l.joint.name.startswith("hip")]
    assert len(hips) == 4
    for j in hips:
        assert j.axis == pytest.approx((0, 0, 1))
        assert (j.lower, j.upper) == pytest.approx((-np.deg2rad(40), np.deg2rad(40)))
        assert j.armature == 0.01 and j.damping == 0.1 and j.has_limits
    assert all(g.density == 5.0 for l in got.links for g in l.geoms)


def _ant_sims(num_envs=2):
    out = []
    for Builder, Sim, Plane, Params, load, fin in (
            (JaxBuilder, JaxSimulator, JaxPlane, JaxSimParams, jmjcf.load_mjcf, lambda b: b.finalize()),
            (SceneBuilder, Simulator, PlaneParams, SimParams, load_mjcf,
             lambda b: b.finalize("cpu"))):
        sp = Params(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, -9.8))
        sp.physx.num_position_iterations = 4
        b = Builder(sp)
        b.add_ground(Plane())
        ant = load(ASSET_ROOT, ANT)
        for i in range(num_envs):
            b.create_env((-2, -2, 0), (2, 2, 1), 1)
            b.create_actor(i, ant, pos=(0, 0, 0.55), name="ant", group=i, filter=0)
        sim = Sim(*fin(b)) if Sim is JaxSimulator else Sim(*fin(b), device="cpu")
        out.append(sim)
    return out


def test_ant_standin_steps_like_jax():
    """Three passive steps of 2 Ants (the JAX step op by op) within 1e-4 *
    max(|ref|, 1): the importer's inertials, frames and limits drive the same
    dynamics."""
    jsim, tsim = _ant_sims()
    js, ts = jsim.state, tsim.state
    for k in range(3):
        with jax.disable_jit():
            js = jsim.stepper.step(js, jsim.actions, jsim.params)
        ts = tsim.stepper.step(ts, tsim.actions, tsim.params)
        got = to_numpy(ts)
        for key in ("root_pos", "root_quat", "root_linvel", "root_angvel", "dof_pos", "dof_vel"):
            want = np.asarray(getattr(js, key))
            err = np.abs(got[key] - want).max()
            assert err <= TOL * max(np.abs(want).max(), 1.0), (k, key, err)
    assert torch.isfinite(ts.root_pos).all()

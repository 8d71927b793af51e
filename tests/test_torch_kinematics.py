"""Port parity: articulated kinematics against the JAX package.

`fk`, `joint_world_frames`, `jacobian` and `body_jacobian` of both packages
on the same numpy inputs (RandomState seeds below), for in-code chains (the
pendulum of tests/test_dynamics.py, and a branched chain with tilted
revolute axes, a prismatic, a fixed and a spherical joint, whose expansion
adds synthetic links) and for the mesh-free Panda stand-in, each with a fixed
and a floating base. Tolerance: 1e-5 * max(|ref|, 1) of each output.
The stand-in's Jacobian is also held against finite differences of FK.

The asset and topology helpers here are shared with test_torch_dynamics.py.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_isaacgym_tpu.physics import kinematics as jk
from test_isaacgym_tpu_torch.envs.franka import FRANKA_URDF, STANDIN_ROOT
from test_isaacgym_tpu_torch.physics import kinematics as tk

JAX, PORT = "test_isaacgym_tpu", "test_isaacgym_tpu_torch"
TOL = 1e-5
BATCH = 5


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def pendulum_asset(pkg, fixed=True):
    """tests/test_dynamics.py::pendulum_asset: a 2 kg bob 1 m below a
    revolute joint about y at the root."""
    t = _mod(pkg, "assets.types")
    root = t.LinkSpec(name="base", mass=1.0, inertia=np.eye(3) * 1e-2, explicit_inertial=True)
    bob = t.LinkSpec(
        name="bob", parent=0,
        joint=t.JointSpec(name="hinge", jtype="revolute", axis=(0, 1, 0)),
        mass=2.0, com=(0, 0, -1.0), inertia=np.eye(3) * 1e-6, explicit_inertial=True,
    )
    return t.AssetSpec(name="pendulum", links=[root, bob], fix_base_link=fixed)


def chain_asset(pkg, fixed=True):
    """A branched chain: base -> l1 (revolute z) -> l2 (revolute about a
    tilted axis, rotated joint frame) -> l3 (prismatic) -> l4 (fixed), and
    base -> l5 (spherical, expanded into three revolute sub-joints)."""
    t = _mod(pkg, "assets.types")
    s2 = np.sqrt(0.5)

    def link(name, parent, joint, mass, com, diag):
        return t.LinkSpec(name=name, parent=parent, joint=joint, mass=mass, com=com,
                          inertia=np.diag(diag), explicit_inertial=True)

    links = [
        link("base", -1, None, 3.0, (0.01, 0.0, 0.05), (0.02, 0.03, 0.04)),
        link("l1", 0, t.JointSpec(name="j1", jtype="revolute", axis=(0, 0, 1),
                                  parent_pos=(0, 0, 0.3)),
             1.5, (0.0, 0.05, 0.1), (0.01, 0.012, 0.004)),
        link("l2", 1, t.JointSpec(name="j2", jtype="revolute", axis=(s2, s2, 0),
                                  parent_pos=(0.2, 0, 0.1), parent_quat=(0, s2, 0, s2)),
             1.0, (0.1, 0.0, 0.0), (0.003, 0.008, 0.008)),
        link("l3", 2, t.JointSpec(name="j3", jtype="prismatic", axis=(1, 0, 0),
                                  parent_pos=(0.25, 0, 0)),
             0.5, (0.02, 0.01, 0.0), (0.001, 0.002, 0.002)),
        link("l4", 3, t.JointSpec(name="j4", jtype="fixed", parent_pos=(0.05, 0.02, 0),
                                  parent_quat=(0.5, 0.5, 0.5, 0.5)),
             0.3, (0.0, 0.0, 0.02), (0.0005, 0.0005, 0.0008)),
        link("l5", 0, t.JointSpec(name="j5", jtype="spherical", parent_pos=(-0.2, 0, 0.1)),
             0.8, (0.0, 0.0, -0.15), (0.004, 0.004, 0.001)),
    ]
    return t.AssetSpec(name="chain", links=links, fix_base_link=fixed)


def standin_asset(pkg, fixed=True):
    """The mesh-free Panda stand-in, loaded as FrankaOscEnv loads it."""
    load_urdf = _mod(pkg, "assets").load_urdf
    return load_urdf(STANDIN_ROOT, FRANKA_URDF, fix_base_link=fixed, armature=0.01)


ASSETS = {"pendulum": pendulum_asset, "chain": chain_asset, "standin": standin_asset}
CASES = [(name, fixed) for name in ASSETS for fixed in (True, False)]


def topo_of(pkg, name, fixed):
    """The articulation topology of one actor of asset `name` in a one-env
    scene of package `pkg` (the port's on the CPU)."""
    scene_mod = _mod(pkg, "core.scene")
    b = scene_mod.SceneBuilder()
    b.create_env((-1, -1, 0), (1, 1, 0), 1)
    b.create_actor(0, ASSETS[name](pkg, fixed), name="a")
    if pkg == JAX:
        return jk.topo_from_group(b.finalize()[0].art_groups[0])
    return tk.topo_from_group(b.finalize("cpu")[0].art_groups[0], "cpu")


def random_state(topo, seed, batch=BATCH):
    """numpy (root_pos, root_quat, root_linvel, root_angvel, q, qd)."""
    rng = np.random.RandomState(seed)
    D = topo.num_dofs
    quat = rng.normal(size=(batch, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    arrays = (
        rng.uniform(-1, 1, (batch, 3)), quat,
        rng.normal(size=(batch, 3)) * 0.3, rng.normal(size=(batch, 3)) * 0.5,
        rng.uniform(-1, 1, (batch, D)), rng.normal(size=(batch, D)),
    )
    return tuple(np.asarray(a, np.float32) for a in arrays)


def close(got, want, what="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol} * {scale:.3g}"


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("name,fixed", CASES)
def test_fk_frames_and_jacobians_match_jax(name, fixed):
    jtopo, ttopo = topo_of(JAX, name, fixed), topo_of(PORT, name, fixed)
    assert ttopo.parent == jtopo.parent and ttopo.dof_of_link == jtopo.dof_of_link
    for f in ("axis", "jp_pos", "jp_quat", "jc_pos", "jc_quat", "mass", "com", "inertia"):
        close(getattr(ttopo, f).numpy(), getattr(jtopo, f), f)
    state = random_state(jtopo, seed=len(name) + 10 * fixed)
    want = jk.fk(jtopo, *_j(state))
    got = tk.fk(ttopo, *_t(state))
    for g, w, what in zip(got, want, ("pos", "quat", "linvel", "angvel")):
        close(g.numpy(), w, f"fk {what}")
    pos, quat = want[0], want[1]
    tpos, tquat = torch.as_tensor(np.array(pos)), torch.as_tensor(np.array(quat))
    for g, w, what in zip(tk.joint_world_frames(ttopo, tpos, tquat),
                          jk.joint_world_frames(jtopo, pos, quat), ("anchors", "axes")):
        close(g.numpy(), w, what)
    close(tk.jacobian(ttopo, tpos, tquat).numpy(), jk.jacobian(jtopo, pos, quat), "jacobian")
    for link in range(jtopo.num_links):
        close(tk.body_jacobian(ttopo, tpos, tquat, link).numpy(),
              jk.body_jacobian(jtopo, pos, quat, link), f"body_jacobian {link}")


def test_topology_masks_match_jax():
    """The port's masks, built once per topology, equal the JAX package's
    `topo_masks` on every case's topology."""
    for name, fixed in CASES:
        jtopo, ttopo = topo_of(JAX, name, fixed), topo_of(PORT, name, fixed)
        want, got = jk.topo_masks(jtopo), ttopo.masks
        for f in jk.TopoMasks._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), f)


@pytest.mark.parametrize("fixed", [True, False])
def test_standin_jacobian_matches_fd(fixed):
    """Jacobian columns of the stand-in against (a) FK link velocities at
    qd = e_i, as tests/test_dynamics.py::test_jacobian_matches_fd, and (b)
    central differences of FK link positions (f32, eps 1e-3)."""
    topo = topo_of(PORT, "standin", fixed)
    rp, rq, rl, ra, q, _ = (torch.as_tensor(a) for a in random_state(topo, seed=5, batch=2))
    if fixed:
        rl, ra = torch.zeros_like(rl), torch.zeros_like(ra)
    D = topo.num_dofs
    pos, quat, _, _ = tk.fk(topo, rp, rq, rl, ra, q, torch.zeros_like(q))
    J = tk.jacobian(topo, pos, quat)  # (2, L, 6, nv)
    base = 0 if fixed else 6
    eps = 1e-3
    for i in range(D):
        e = torch.zeros_like(q)
        e[:, i] = 1.0
        _, _, lin_i, ang_i = tk.fk(topo, rp, rq, torch.zeros_like(rl), torch.zeros_like(ra), q, e)
        np.testing.assert_allclose(J[..., 0:3, base + i].numpy(), lin_i.numpy(), atol=1e-4)
        np.testing.assert_allclose(J[..., 3:6, base + i].numpy(), ang_i.numpy(), atol=1e-4)
        p_hi = tk.fk(topo, rp, rq, rl, ra, q + eps * e, q * 0)[0]
        p_lo = tk.fk(topo, rp, rq, rl, ra, q - eps * e, q * 0)[0]
        fd = (p_hi - p_lo) / (2 * eps)
        np.testing.assert_allclose(J[..., 0:3, base + i].numpy(), fd.numpy(), atol=2e-3)

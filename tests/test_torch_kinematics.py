"""Port parity: articulated kinematics against the JAX package.

`fk`, `joint_world_frames`, `jacobian` and `body_jacobian` of both packages
on the same numpy inputs (RandomState seeds below), for in-code chains (the
pendulum of tests/test_dynamics.py, and a branched chain with tilted
revolute axes, a prismatic, a fixed and a spherical joint, whose expansion
adds synthetic links) and for the mesh-free Panda stand-in, each with a fixed
and a floating base. Tolerance: 1e-5 * max(|ref|, 1) of each output.
The stand-in's Jacobian is also held against finite differences of FK.

The port's `fk` launches the hand-written kernel csrc/fk.cu on CUDA tensors
and takes its plain version `_fk_torch` on CPU tensors. Here on the CPU: the
dispatch, the kernel's topology tables against the topology, the wrapper's
refusals, and the plain version against the JAX package on the two
topologies the kernel's cases add. The `cuda` tests at the end, which run only where a CUDA device is
present, hold the kernel to `_fk_torch` on the card at the default tolerance
1e-4 * max(|ref|, 1): the Panda stand-in at 4,096 envs, a floating-base
chain, a prismatic-and-revolute chain, three copies an env, a batch of
4,097, a topology with no dofs; then bitwise repeatability, one launch a
call, the refusals, and a Franka step with host syncs made errors.

The asset and topology helpers here are shared with test_torch_dynamics.py.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_isaacgym_tpu.physics import kinematics as jk
from test_isaacgym_tpu_torch.envs.franka import FRANKA_URDF, STANDIN_ROOT
from test_isaacgym_tpu_torch.ops import _kernels
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


def prismatic_revolute_asset(pkg, fixed=False):
    """base -> l1 (prismatic along z) -> l2 (revolute about x, rotated joint
    frame) -> l3 (prismatic along a tilted axis) -> l4 (revolute about y)."""
    t = _mod(pkg, "assets.types")
    s2 = np.sqrt(0.5)

    def link(name, parent, joint, mass):
        return t.LinkSpec(name=name, parent=parent, joint=joint, mass=mass, com=(0.0, 0.02, 0.05),
                          inertia=np.diag((0.01, 0.02, 0.03)), explicit_inertial=True)

    links = [
        link("base", -1, None, 2.0),
        link("l1", 0, t.JointSpec(name="p1", jtype="prismatic", axis=(0, 0, 1),
                                  parent_pos=(0.1, 0, 0.2)), 1.0),
        link("l2", 1, t.JointSpec(name="r2", jtype="revolute", axis=(1, 0, 0),
                                  parent_pos=(0, 0.3, 0), parent_quat=(0, 0, s2, s2)), 0.8),
        link("l3", 2, t.JointSpec(name="p3", jtype="prismatic", axis=(s2, 0, s2),
                                  parent_pos=(0.2, 0, 0)), 0.5),
        link("l4", 3, t.JointSpec(name="r4", jtype="revolute", axis=(0, 1, 0),
                                  parent_pos=(0, 0, 0.15)), 0.3),
    ]
    return t.AssetSpec(name="prismatic_revolute", links=links, fix_base_link=fixed)


def rigid_asset(pkg, fixed=False):
    """Three links joined by fixed joints: a topology with no dofs."""
    t = _mod(pkg, "assets.types")

    def link(name, parent, joint):
        return t.LinkSpec(name=name, parent=parent, joint=joint, mass=1.0, com=(0, 0, 0.05),
                          inertia=np.diag((0.01, 0.02, 0.03)), explicit_inertial=True)

    links = [link("base", -1, None),
             link("a", 0, t.JointSpec(name="f1", jtype="fixed", parent_pos=(0.1, 0, 0.2),
                                      parent_quat=(0.5, 0.5, 0.5, 0.5))),
             link("b", 1, t.JointSpec(name="f2", jtype="fixed", parent_pos=(0, 0.3, 0)))]
    return t.AssetSpec(name="rigid", links=links, fix_base_link=fixed)


# the kernel's cases add these two topologies
KERNEL_ASSETS = dict(ASSETS, prismatic_revolute=prismatic_revolute_asset, rigid=rigid_asset)


def topo_of(pkg, name, fixed, device="cpu"):
    """The articulation topology of one actor of asset `name` (KERNEL_ASSETS)
    in a one-env scene of package `pkg` (the port's on `device`)."""
    scene_mod = _mod(pkg, "core.scene")
    b = scene_mod.SceneBuilder()
    b.create_env((-1, -1, 0), (1, 1, 0), 1)
    b.create_actor(0, KERNEL_ASSETS[name](pkg, fixed), name="a")
    if pkg == JAX:
        return jk.topo_from_group(b.finalize()[0].art_groups[0])
    return tk.topo_from_group(b.finalize("cpu")[0].art_groups[0], device)


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


# ---------------------------------------------------------------------------
# the hand-written kernel (csrc/fk.cu): its tables and dispatch on the CPU,
# then the kernel against the plain version on the card (`cuda` tests)
# ---------------------------------------------------------------------------
KERNEL_TOL = 1e-4  # the default tolerance: kernel vs plain, 1e-4 * max(|ref|, 1)




@pytest.mark.parametrize("name,fixed", CASES + [("prismatic_revolute", False), ("rigid", False)])
def test_fk_table_equals_the_topology(name, fixed):
    """The kernel's tables, packed once per topology, hold the ArtTopo
    fields they were built from: (parent, jtype, dof) and (axis, jp_pos,
    jp_quat, jc_pos, jc_quat) a link, int32 and float32, on its device."""
    topo = topo_of(PORT, name, fixed)
    ints, floats = topo.fk_ints, topo.fk_floats
    assert ints.dtype == torch.int32 and floats.dtype == torch.float32
    assert ints.shape == (topo.num_links, 3) and floats.shape == (topo.num_links, 17)
    for col, field in enumerate(("parent", "jtype", "dof_of_link")):
        assert ints[:, col].tolist() == list(getattr(topo, field)), field
    at = 0
    for field, width in (("axis", 3), ("jp_pos", 3), ("jp_quat", 4), ("jc_pos", 3),
                         ("jc_quat", 4)):
        assert torch.equal(floats[:, at:at + width], getattr(topo, field)), field
        at += width


def test_fk_table_refuses_a_parent_after_its_link():
    """The kernel reads each parent's result back, so a link whose parent
    comes later (or is missing) is refused when the table is packed."""
    z3, z4 = np.zeros((2, 3)), np.zeros((2, 4))
    JT_REV = _mod(PORT, "core.scene").JT_REVOLUTE
    for parent in ((-1, 1), (-1, 2), (-1, -1)):
        with pytest.raises(ValueError, match="does not come before it"):
            tk.fk_table(parent, (0, JT_REV), (-1, 0), z3, z3, z4, z3, z4, "cpu")


def test_fk_takes_the_plain_version_on_cpu(monkeypatch):
    """CPU tensors go to _fk_torch, and the kernel's count does not move."""
    topo = topo_of(PORT, "standin", True)
    state = _t(random_state(topo, seed=4))
    calls = []
    monkeypatch.setattr(tk, "_fk_torch", lambda *a: calls.append(a) or "plain")
    monkeypatch.setattr(tk, "_fk_cuda", lambda *a: pytest.fail("the kernel's wrapper ran"))
    before = dict(_kernels.launches)
    assert tk.fk(topo, *state) == "plain" and len(calls) == 1
    assert dict(_kernels.launches) == before


def test_fk_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper's device and dtype check raises before any library is
    loaded: CPU tensors, float32 or float64, are refused by name."""
    topo = topo_of(PORT, "standin", True)
    state = _t(random_state(topo, seed=4))
    with pytest.raises(ValueError, match="one CUDA device"):
        tk._fk_cuda(topo, *state)
    with pytest.raises(ValueError, match="one CUDA device"):
        tk._fk_cuda(topo, *(a.double() for a in state))


@pytest.mark.parametrize("name,fixed", [("prismatic_revolute", False), ("rigid", False)])
def test_fk_matches_jax_on_the_kernel_topologies(name, fixed):
    """The plain version against the JAX package on the two topologies the
    kernel's cases add: a prismatic-and-revolute chain and one with no dofs."""
    jtopo, ttopo = topo_of(JAX, name, fixed), topo_of(PORT, name, fixed)
    state = random_state(jtopo, seed=3)
    for g, w, what in zip(tk.fk(ttopo, *_t(state)), jk.fk(jtopo, *_j(state)),
                          ("pos", "quat", "linvel", "angvel")):
        close(g.numpy(), w, f"{name} fk {what}")


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def kernel_inputs(topo, case, seed=7):
    """Random CUDA inputs of one card case: (batch shape, the six tensors).
    Fixed bases get zero root velocities, as their step gives them."""
    shape = {"standin4096": (4096,), "copies3": (64, 3), "batch4097": (4097,)}.get(case, (256,))
    state = random_state(topo, seed, batch=int(np.prod(shape)))
    args = [torch.as_tensor(a, device="cuda").reshape(shape + a.shape[-1:]) for a in state]
    if topo.fixed_base:
        args[2], args[3] = torch.zeros_like(args[2]), torch.zeros_like(args[3])
    return shape, args


KERNEL_CASES = {  # case -> (asset, fixed base)
    "standin4096": ("standin", True),  # revolute, prismatic and fixed joints
    "floating_chain": ("chain", False),  # a floating base with root velocities
    "prismatic_revolute": ("prismatic_revolute", False),
    "copies3": ("standin", True),  # K = 3 copies an env: (N, K, ...) inputs
    "batch4097": ("standin", True),  # not a multiple of the block
    "no_dofs": ("rigid", False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_fk_kernel_matches_plain_on_cuda(case):
    """The kernel against _fk_torch on the same CUDA tensors, every output
    within 1e-4 * max(|ref|, 1); exactly one launch a call."""
    _needs_cuda()
    topo = topo_of(PORT, *KERNEL_CASES[case], device="cuda")
    shape, args = kernel_inputs(topo, case)
    before = _kernels.launches["fk"]
    got = tk.fk(topo, *args)
    assert _kernels.launches["fk"] == before + 1
    want = tk._fk_torch(topo, *args)
    torch.cuda.synchronize()
    L = topo.num_links
    for g, w, what, width in zip(got, want, ("pos", "quat", "linvel", "angvel"), (3, 4, 3, 3)):
        assert g.shape == shape + (L, width) and g.dtype == torch.float32 and g.is_cuda
        close(g.cpu().numpy(), w.cpu().numpy(), f"{case} {what}", tol=KERNEL_TOL)


@pytest.mark.cuda
def test_fk_kernel_is_bitwise_repeatable():
    """Two launches on the same inputs give the same bits."""
    _needs_cuda()
    topo = topo_of(PORT, "standin", True, device="cuda")
    _, args = kernel_inputs(topo, "standin4096")
    for x, y in zip(tk.fk(topo, *args), tk.fk(topo, *args)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_fk_kernel_refuses_float64_and_grad():
    """A float64 input or one that requires grad raises on the card, with
    nothing launched: no caller differentiates fk, and the kernel is f32."""
    _needs_cuda()
    topo = topo_of(PORT, "standin", True, device="cuda")
    _, args = kernel_inputs(topo, "floating_chain")
    before = _kernels.launches["fk"]
    with pytest.raises(ValueError, match="float32"):
        tk.fk(topo, *(a.double() for a in args))
    grad = list(args)
    grad[4] = grad[4].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        tk.fk(topo, *grad)
    assert _kernels.launches["fk"] == before


@pytest.mark.cuda
def test_franka_step_launches_fk_twice_sync_free():
    """A FrankaOscEnv step on the card runs with host syncs made errors and
    launches the fk kernel twice: phase A's second substep and the refresh."""
    _needs_cuda()
    from test_isaacgym_tpu_torch.envs.franka import FrankaOscEnv

    env = FrankaOscEnv(num_envs=64, device="cuda")
    one = env.rollout_fn(1)
    state = one(env.sim.state)  # warm: allocator, library and handles
    torch.cuda.synchronize()
    before = _kernels.launches["fk"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = one(state)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _kernels.launches["fk"] == before + 2
    assert torch.isfinite(state.dof_pos).all()


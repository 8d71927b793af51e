"""Port parity: the gymapi facade (gymapi/facade.py, mathtypes.py, gymtorch.py,
gymutil.py) against the JAX package's, call for call.

The repo-only counterpart of tests/test_gymapi.py, whose scenes mostly read
the reference's assets: each scene here is written once as a function of a
package's (gymapi, gymtorch) and run through both facades, the port's on CPU
tensors (`create_sim(..., device="cpu")`). Scenes are made of primitives,
the committed Panda, Ant and icosphere stand-ins, and a cartpole URDF
written into tmp_path.

Tolerances: exact for handles, names, counts, dtypes and structured-array
fields that are not floats of a trajectory; 1e-6 for the math types;
1e-4 * max(|ref|, 1) (the goldens' rule) for trajectories and everything
the step computes; the render tests' rule for images (segmentation equal
and colour within one count on all but 1% of the pixels). The aliasing of the
device tensor handles is the port's own behaviour, checked on the port.
"""
import numpy as np
import pytest
import torch

import test_isaacgym_tpu  # noqa: F401  (CPU platform before jax init)
from test_isaacgym_tpu import gymapi as jgymapi
from test_isaacgym_tpu import gymtorch as jgymtorch
from test_isaacgym_tpu import gymutil as jgymutil
from test_isaacgym_tpu_torch import gymapi, gymtorch, gymutil
from test_isaacgym_tpu_torch.envs.franka import FRANKA_URDF, STANDIN_ROOT
from test_isaacgym_tpu_torch.envs.soft_body import ICOSPHERE_URDF
from test_isaacgym_tpu_torch.envs.soft_body import STANDIN_ROOT as ICOSPHERE_ROOT

ATOL = 1e-4
PORT = (gymapi, gymtorch, {"device": "cpu"})
JAX = (jgymapi, jgymtorch, {})
ANT_ROOT = STANDIN_ROOT.replace("panda_standin", "ant_standin")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def both(scene, *args):
    """scene(gymapi, gymtorch, sim_kw, *args) through the port, then the JAX
    facade."""
    return scene(*PORT, *args), scene(*JAX, *args)


def assert_close(got, want, what, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    assert err <= atol * scale, f"{what}: max |err| {err:.3e} > {atol} * {scale:.3g}"


def assert_struct_equal(got, want, what):
    """Structured arrays: same dtype, every leaf field equal."""
    assert got.dtype == want.dtype, what

    def leaves(a, prefix=""):
        if a.dtype.names is None:
            yield prefix, a
            return
        for n in a.dtype.names:
            yield from leaves(a[n], f"{prefix}.{n}")

    for (name, g), (_, w) in zip(leaves(got), leaves(want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}{name}")


def assert_struct_close(got, want, what):
    assert got.dtype == want.dtype, what
    for name in ("pose", "vel"):
        for sub in got[name].dtype.names:
            for f in got[name][sub].dtype.names:
                assert_close(got[name][sub][f], want[name][sub][f], f"{what} {name}.{sub}.{f}")


def ball_scene(gymapi, sim_kw, num_envs=2, z=1.0):
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, gymapi.SimParams(), **sim_kw)
    gym.add_ground(sim, gymapi.PlaneParams())
    opts = gymapi.AssetOptions()
    opts.density = 100.0
    ball = gym.create_sphere(sim, 0.2, opts)
    envs = []
    for i in range(num_envs):
        env = gym.create_env(sim, gymapi.Vec3(-1, -1, 0), gymapi.Vec3(1, 1, 2), 2)
        gym.create_actor(env, ball, gymapi.Transform(gymapi.Vec3(0, 0, z)), "ball", i, 0)
        envs.append(env)
    return gym, sim, envs


# -- math types (examples/maths.py) -------------------------------------------
def _maths(gymapi):
    V, Q, T = gymapi.Vec3, gymapi.Quat, gymapi.Transform
    a, b = V(1, 2, 3), V(4, 5, 6)
    q = Q.from_euler_zyx(0.3, -0.2, 0.9)
    qz = Q.from_axis_angle(V(0, 0, 1), np.pi / 2)
    t = T(V(1, 2, 3), qz)
    p = t.transform_point(V(1, 0, 0))
    out = {
        "add": (a + b).to_list(), "sub": (b - a).to_list(), "neg": (-a).to_list(),
        "mul": (a * 2.5).to_list(), "vmul": (a * b).to_list(), "div": (b / 2).to_list(),
        "dot": [a.dot(b)], "cross": a.cross(b).to_list(), "len": [V(3, 4, 0).length()],
        "normalize": V(3, 4, 0).normalize().to_list(), "q": q.to_list(),
        "euler": list(q.to_euler_zyx()), "rotate": qz.rotate(V(1, 0, 0)).to_list(),
        "qmul": (q * qz).to_list(), "qinv": (q.inverse() * q).normalize().to_list(),
        "qvec": (q * a).to_list(), "point": p.to_list(),
        "vector": t.transform_vector(V(1, 0, 0)).to_list(),
        "inverse": t.inverse().transform_point(p).to_list(),
        "compose": [*(t * t).p.to_list(), *(t * t).r.to_list()],
        "buffer": [*T.from_buffer(np.array([1, 2, 3, 0, 0, 0, 1.0])).p.to_list()],
        "vnp": list(V.from_numpy(a.to_numpy())),
        "qnp": list(Q.from_numpy(q.to_numpy())),
        "tnp": [*T.from_numpy(t.to_numpy()).p.to_list(), *T.from_numpy(t.to_numpy()).r.to_list()],
    }
    dtypes = [gymapi.Vec3.dtype, gymapi.Quat.dtype, gymapi.Transform.dtype,
              gymapi.Velocity.dtype, gymapi.DofState.dtype, gymapi.RigidBodyState.dtype]
    return out, dtypes


def test_math_types_match():
    got, gdt = _maths(gymapi)
    want, wdt = _maths(jgymapi)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert [d.descr for d in gdt] == [d.descr for d in wdt]
    # the reference values of tests/test_gymapi.py's math cases
    assert got["cross"] == [-3, 6, -3] and got["dot"] == [32]
    assert abs(got["euler"][1] + 0.2) < 1e-6 and abs(got["point"][1] - 3) < 1e-6


# -- handles and domains ------------------------------------------------------
def _handles(gymapi, gymtorch, sim_kw):
    gym, sim, envs = ball_scene(gymapi, sim_kw, num_envs=3)
    e = envs[1]
    return [gym.get_actor_count(e), gym.get_actor_name(e, 0), gym.find_actor_handle(e, "ball"),
            gym.find_actor_handle(e, "nope"), gym.get_actor_rigid_body_handle(e, 0, 0),
            gym.get_actor_rigid_body_index(e, 0, 0, gymapi.DOMAIN_SIM),
            gym.get_actor_rigid_body_index(e, 0, 0, gymapi.DOMAIN_ENV),
            gym.find_actor_index(e, "ball", gymapi.DOMAIN_SIM), gym.get_env_count(sim),
            gym.get_actor_rigid_body_names(e, 0), gym.get_actor_dof_count(e, 0),
            gym.get_frame_count(sim)]


def test_actor_handles_and_domains():
    got, want = both(_handles)
    assert got == want
    assert got[5] == 1  # env 1 x 1 body per env


# -- classic loop + snapshot/reset (1080_balls_of_solitude.py:150-158) --------
def _classic(gymapi, gymtorch, sim_kw):
    gym, sim, envs = ball_scene(gymapi, sim_kw)
    snapshot = np.copy(gym.get_sim_rigid_body_states(sim, gymapi.STATE_ALL))
    for _ in range(30):
        gym.simulate(sim)
        gym.fetch_results(sim, True)
    fell = gym.get_actor_rigid_body_states(envs[0], 0, gymapi.STATE_ALL)
    all_fell = np.copy(gym.get_sim_rigid_body_states(sim, gymapi.STATE_ALL))
    t = gym.get_sim_time(sim)
    gym.set_sim_rigid_body_states(sim, snapshot, gymapi.STATE_ALL)
    back = gym.get_actor_rigid_body_states(envs[0], 0, gymapi.STATE_ALL)
    # a root write of one actor, velocity only
    st = np.copy(back)
    st["vel"]["linear"]["x"] = 0.5
    gym.set_actor_rigid_body_states(envs[1], 0, st, gymapi.STATE_VEL)
    v = gym.get_rigid_linear_velocity(envs[1], 0)
    gym.set_rigid_angular_velocity(envs[0], 0, gymapi.Vec3(0, 0, 2.0))
    w = gym.get_rigid_angular_velocity(envs[0], 0)
    pose = gym.get_rigid_transform(envs[1], 0)
    return dict(snapshot=snapshot, fell=fell, all_fell=all_fell, back=back, t=t,
                v=v.to_list(), w=w.to_list(), pose=[*pose.p.to_list(), *pose.r.to_list()],
                frames=gym.get_frame_count(sim))


def test_classic_loop_and_reset():
    got, want = both(_classic)
    assert_struct_equal(got["snapshot"], want["snapshot"], "snapshot")
    assert_struct_close(got["fell"], want["fell"], "after 30 steps")
    assert_struct_close(got["all_fell"], want["all_fell"], "sim states after 30 steps")
    assert_struct_equal(got["back"], got["snapshot"][:1], "reset")
    assert_struct_equal(got["back"], want["back"], "reset vs jax")
    assert got["fell"]["pose"]["p"]["z"][0] < 1.0  # fell under gravity
    assert got["t"] == pytest.approx(want["t"]) and got["frames"] == want["frames"] == 30
    for k in ("v", "w", "pose"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert got["v"][0] == pytest.approx(0.5) and got["w"][2] == pytest.approx(2.0)


# -- tensor API (test06:417-442, interop_torch.py:131-149) --------------------
def _root_tensor(gymapi, gymtorch, sim_kw):
    gym, sim, envs = ball_scene(gymapi, sim_kw)
    handle = gym.acquire_actor_root_state_tensor(sim)
    buf = gymtorch.wrap_tensor(handle)
    out = {"shape": tuple(buf.shape), "dtype": str(buf.dtype), "initial": _np(buf).copy()}
    for _ in range(10):
        gym.simulate(sim)
    gym.refresh_actor_root_state_tensor(sim)
    out["fallen"] = _np(buf).copy()
    # write back: teleport up with zero velocity
    buf[:, 2] = 2.0
    buf[:, 7:13] = 0.0
    gym.set_actor_root_state_tensor(sim, gymtorch.unwrap_tensor(buf))
    gym.refresh_actor_root_state_tensor(sim)
    out["teleported"] = _np(buf).copy()
    gym.simulate(sim)
    gym.refresh_actor_root_state_tensor(sim)
    out["after"] = _np(buf).copy()
    body = gymtorch.wrap_tensor(gym.acquire_rigid_body_state_tensor(sim))
    out["body"] = _np(body).copy()
    body[:, 0] += 0.25
    gym.set_rigid_body_state_tensor(sim, body)
    gym.refresh_actor_root_state_tensor(sim)
    out["body_set"] = _np(buf).copy()
    return out


def test_tensor_api_root_state():
    got, want = both(_root_tensor)
    assert got["shape"] == want["shape"] == (2, 13)
    assert got["dtype"] == want["dtype"] == "torch.float32"
    np.testing.assert_array_equal(got["initial"], want["initial"])
    for k in ("fallen", "teleported", "after", "body", "body_set"):
        assert_close(got[k], want[k], k)
    assert got["fallen"][0, 2] < 1.0
    assert abs(got["teleported"][0, 2] - 2.0) < 1e-6


def test_wrap_tensor_aliases_across_refreshes_and_set_takes_it():
    """The port's handles are tensors on the sim's device, allocated once:
    wrap_tensor returns the handle's own tensor, every refresh writes into
    the same storage, and set_*_tensor takes the wrapped tensor as it is."""
    gym, sim, envs = ball_scene(gymapi, {"device": "cpu"})
    handle = gym.acquire_actor_root_state_tensor(sim)
    root = gymtorch.wrap_tensor(handle)
    assert root is handle.buf and handle.data_address == root.data_ptr()
    assert gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim)) is root
    dof = gymtorch.wrap_tensor(gym.acquire_dof_state_tensor(sim))
    ptrs, zs = set(), []
    for _ in range(10):
        gym.simulate(sim)
        gym.refresh_actor_root_state_tensor(sim)
        ptrs.add(root.data_ptr())
        zs.append(float(root[0, 2]))
    assert ptrs == {handle.data_address} and len(set(zs)) == 10
    assert gymtorch.unwrap_tensor(root) is root
    root[:, 2] = 1.5
    gym.set_actor_root_state_tensor(sim, root)
    # the sim copied the values: writing the tensor again moves nothing
    root[:, 2] = 9.0
    gym.refresh_actor_root_state_tensor(sim)
    assert root.data_ptr() == handle.data_address
    assert torch.all(root[:, 2] == 1.5)
    assert dof.shape == (0, 2)


def _contact(gymapi, gymtorch, sim_kw):
    gym, sim, envs = ball_scene(gymapi, sim_kw, z=0.19)
    cf = gymtorch.wrap_tensor(gym.acquire_net_contact_force_tensor(sim))
    for _ in range(20):
        gym.simulate(sim)
    gym.refresh_net_contact_force_tensor(sim)
    return _np(cf).copy()


def test_contact_force_tensor():
    got, want = both(_contact)
    assert_close(got, want, "net contact force")
    assert got[0, 2] > 0.0  # resting ball: normal force upward


# -- DOF drive modes (examples/dof_controls.py:91-150) on a cartpole ----------
CARTPOLE = """<?xml version="1.0"?>
<robot name="cartpole">
  <link name="slider">
    <inertial><mass value="10"/><inertia ixx="1" ixy="0" ixz="0" iyy="1" iyz="0" izz="1"/></inertial>
    <collision><geometry><box size="0.03 8 0.03"/></geometry></collision>
  </link>
  <joint name="slider_to_cart" type="prismatic">
    <parent link="slider"/><child link="cart"/>
    <axis xyz="0 1 0"/><origin xyz="0 0 0"/>
    <limit lower="-4" upper="4" effort="1000" velocity="100"/>
  </joint>
  <link name="cart">
    <inertial><mass value="1"/><inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.01"/></inertial>
    <collision><geometry><box size="0.5 0.5 0.2"/></geometry></collision>
  </link>
  <joint name="cart_to_pole" type="revolute">
    <parent link="cart"/><child link="pole"/>
    <axis xyz="1 0 0"/><origin xyz="0.12 0 0"/>
    <limit lower="-3.14" upper="3.14" effort="1000" velocity="100"/>
  </joint>
  <link name="pole">
    <inertial><origin xyz="0 0 0.47"/><mass value="1"/>
      <inertia ixx="0.07" ixy="0" ixz="0" iyy="0.07" iyz="0" izz="0.001"/></inertial>
    <collision><origin xyz="0 0 0.47"/><geometry><box size="0.04 0.06 1.0"/></geometry></collision>
  </link>
</robot>
"""


def _cartpole(gymapi, gymtorch, sim_kw, root):
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, gymapi.SimParams(), **sim_kw)
    gym.add_ground(sim, gymapi.PlaneParams())
    asset = gym.load_asset(sim, root, "cartpole.urdf", gymapi.AssetOptions(fix_base_link=True))
    out = {"names": (gym.get_asset_dof_names(asset), gym.get_asset_rigid_body_names(asset),
                     gym.get_asset_joint_names(asset)),
           "types": [gym.get_dof_type_string(gym.get_asset_dof_type(asset, i)) for i in range(2)],
           "props": gym.get_asset_dof_properties(asset)}
    envs, dofs = [], []
    for i in range(2):
        env = gym.create_env(sim, gymapi.Vec3(-2, -2, 0), gymapi.Vec3(2, 2, 2), 2)
        actor = gym.create_actor(env, asset, gymapi.Transform(gymapi.Vec3(0, 0, 2)), "cartpole", i, 0)
        props = gym.get_actor_dof_properties(env, actor)
        props["driveMode"][:] = gymapi.DOF_MODE_POS if i == 0 else gymapi.DOF_MODE_VEL
        props["stiffness"][:] = 400.0 if i == 0 else 0.0
        props["damping"][:] = 40.0
        gym.set_actor_dof_properties(env, actor, props)
        dof = gym.get_actor_dof_handle(env, actor, 0)
        if i == 0:
            gym.set_dof_target_position(env, dof, 0.3)
        envs.append(env)
        dofs.append(dof)
    gym.set_dof_target_velocity(envs[1], dofs[1], 0.5)
    gym.set_actor_dof_position_targets(envs[0], 0, np.array([0.3, 0.1], np.float32))
    out["targets"] = gym.get_actor_dof_position_targets(envs[0], 0)
    for _ in range(60):
        gym.simulate(sim)
    gym.apply_dof_effort(envs[1], gym.get_actor_dof_handle(envs[1], 0, 1), 5.0)
    for _ in range(60):
        gym.simulate(sim)
    out["pos"] = [gym.get_dof_position(envs[0], dofs[0]), gym.get_dof_velocity(envs[1], dofs[1])]
    out["states"] = np.concatenate([gym.get_actor_dof_states(e, 0, gymapi.STATE_ALL) for e in envs])
    out["actor_props"] = gym.get_actor_dof_properties(envs[1], 0)
    frame = gym.get_dof_frame(envs[0], gym.get_actor_dof_handle(envs[0], 0, 1))
    out["frame"] = [*frame.origin.to_list(), *frame.axis.to_list()]
    dof_state = gymtorch.wrap_tensor(gym.acquire_dof_state_tensor(sim))
    dof_state[:, 1] = 0.0
    gym.set_dof_state_tensor(sim, dof_state)
    gym.set_dof_position_target_tensor(sim, torch.zeros(4))
    gym.set_dof_velocity_target_tensor(sim, torch.full((4,), 0.2))
    for _ in range(10):
        gym.simulate(sim)
    gym.refresh_dof_state_tensor(sim)
    out["dof_state"] = _np(dof_state).copy()
    return out


def test_dof_drives_cartpole(tmp_path):
    (tmp_path / "cartpole.urdf").write_text(CARTPOLE)
    got, want = both(_cartpole, str(tmp_path))
    assert got["names"] == want["names"] and got["types"] == want["types"]
    assert_struct_equal(got["props"], want["props"], "asset dof props")
    assert_struct_equal(got["actor_props"], want["actor_props"], "actor dof props")
    np.testing.assert_array_equal(got["targets"], want["targets"])
    assert_close(got["pos"], want["pos"], "dof position, velocity")
    for f in ("pos", "vel"):
        assert_close(got["states"][f], want["states"][f], f"dof states {f}")
    assert_close(got["frame"], want["frame"], "dof frame")
    assert_close(got["dof_state"], want["dof_state"], "dof state tensor")
    assert abs(got["pos"][0] - 0.3) < 0.05  # the position drive reached its target


# -- the Panda and Ant stand-ins: introspection, attractors --------------------
def _introspect(gymapi, gymtorch, sim_kw):
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, gymapi.SimParams(), **sim_kw)
    out = {}
    for key, root, fname, fix in (("panda", STANDIN_ROOT, FRANKA_URDF, True),
                                  ("ant", ANT_ROOT, "mjcf/nv_ant.xml", False)):
        a = gym.load_asset(sim, root, fname, gymapi.AssetOptions(fix_base_link=fix))
        out[key] = dict(
            counts=[gym.get_asset_rigid_body_count(a), gym.get_asset_joint_count(a),
                    gym.get_asset_dof_count(a), gym.get_asset_soft_body_count(a),
                    gym.get_asset_actuator_count(a), gym.get_asset_tendon_count(a)],
            names=[gym.get_asset_rigid_body_names(a), gym.get_asset_joint_names(a),
                   gym.get_asset_dof_names(a), gym.get_asset_rigid_body_dict(a),
                   gym.get_asset_joint_dict(a), gym.get_asset_dof_dict(a)],
            types=[gym.get_joint_type_string(gym.get_asset_joint_type(a, i))
                   for i in range(gym.get_asset_joint_count(a))]
            + [gym.get_dof_type_string(gym.get_asset_dof_type(a, i))
               for i in range(gym.get_asset_dof_count(a))],
            props=gym.get_asset_dof_properties(a),
        )
    return out


def test_asset_introspection_panda_and_ant():
    got, want = both(_introspect)
    for key in ("panda", "ant"):
        g, w = got[key], want[key]
        assert g["counts"] == w["counts"] and g["names"] == w["names"], key
        assert g["types"] == w["types"], key
        assert_struct_equal(g["props"], w["props"], key)
    assert got["panda"]["counts"][2] == 9 and got["ant"]["counts"][2] == 8
    assert got["panda"]["names"][3]["panda_link0"] == 0


def _attractor(gymapi, gymtorch, sim_kw):
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, gymapi.SimParams(), **sim_kw)
    gym.add_ground(sim, gymapi.PlaneParams())
    opts = gymapi.AssetOptions(fix_base_link=True)
    opts.disable_gravity = True
    asset = gym.load_asset(sim, STANDIN_ROOT, FRANKA_URDF, opts)
    env = gym.create_env(sim, gymapi.Vec3(-1, -1, 0), gymapi.Vec3(1, 1, 2), 1)
    actor = gym.create_actor(env, asset, gymapi.Transform(), "franka", 0, 1)
    hand = gym.find_actor_rigid_body_handle(env, actor, "panda_hand")
    st = gym.get_actor_dof_states(env, actor, gymapi.STATE_ALL)
    st["pos"][:] = [0.0, 0.0, 0.0, -1.2, 0.0, 1.5, 0.0, 0.02, 0.02]
    gym.set_actor_dof_states(env, actor, st, gymapi.STATE_ALL)
    hand_pose = gym.get_rigid_transform(env, hand)
    prebuild_states = gym.get_actor_rigid_body_states(env, actor, gymapi.STATE_ALL)
    props = gymapi.AttractorProperties()
    props.stiffness, props.damping = 5e5, 5e3
    props.axes = gymapi.AXIS_ALL
    props.rigid_handle = hand
    props.target = hand_pose
    att = gym.create_rigid_body_attractor(env, props)
    target = gymapi.Transform(
        gymapi.Vec3(hand_pose.p.x, hand_pose.p.y, hand_pose.p.z + 0.05), hand_pose.r)
    gym.set_attractor_target(env, att, target)
    got_props = gym.get_attractor_properties(env, att)
    for _ in range(20):
        gym.simulate(sim)
    p = gym.get_attractor_properties(env, att)
    p.stiffness = 2e5
    gym.set_attractor_properties(env, att, p)
    for _ in range(10):
        gym.simulate(sim)
    cur = gym.get_rigid_transform(env, hand)
    return dict(hand=hand, pose=[*hand_pose.p.to_list(), *hand_pose.r.to_list()],
                prebuild=prebuild_states,
                props=[got_props.stiffness, got_props.damping, got_props.rigid_handle,
                       *got_props.target.p.to_list()],
                cur=[*cur.p.to_list(), *cur.r.to_list()],
                states=gym.get_actor_rigid_body_states(env, actor, gymapi.STATE_ALL),
                target=target.p.to_list())


def test_franka_attractor_on_the_standin():
    got, want = both(_attractor)
    assert got["hand"] == want["hand"] and got["props"] == want["props"]
    np.testing.assert_allclose(got["pose"], want["pose"], atol=1e-12)  # the same host FK
    assert_struct_equal(got["prebuild"], want["prebuild"], "pre-build FK states")
    assert_close(got["cur"], want["cur"], "hand pose")
    assert_struct_close(got["states"], want["states"], "body states")
    # the attractor pulled the hand towards the raised target
    assert got["cur"][2] > got["pose"][2] + 0.01


# -- runtime scaling, body/shape properties (actor_scaling.py, body_physics_props.py)
def _properties(gymapi, gymtorch, sim_kw, built_first):
    gym, sim, envs = ball_scene(gymapi, sim_kw, num_envs=3)
    if built_first:
        gym.prepare_sim(sim)
    gym.set_actor_scale(envs[1], 0, 2.0)
    sp = gym.get_actor_rigid_shape_properties(envs[0], 0)
    sp[0].friction, sp[0].restitution = 0.1, 0.9
    gym.set_actor_rigid_shape_properties(envs[0], 0, sp)
    bp = gym.get_actor_rigid_body_properties(envs[0], 0)
    bp[0].flags = gymapi.RIGID_BODY_DISABLE_GRAVITY
    gym.set_actor_rigid_body_properties(envs[0], 0, bp)
    bp2 = gym.get_actor_rigid_body_properties(envs[2], 0)
    bp2[0].mass *= 3.0
    gym.set_actor_rigid_body_properties(envs[2], 0, bp2, True)
    sim._ensure_built()
    p = sim.sim.params
    params = {k: _np(getattr(p, k)).copy() for k in (
        "shape_size", "shape_pos", "shape_friction", "shape_restitution", "body_mass",
        "body_com", "body_inertia", "body_disable_gravity")}
    for _ in range(30):
        gym.simulate(sim)
    root = gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim))
    gym.refresh_actor_root_state_tensor(sim)
    read = gym.get_actor_rigid_body_properties(envs[2], 0)[0]
    shapes = gym.get_actor_rigid_shape_properties(envs[0], 0)[0]
    return dict(params=params, root=_np(root).copy(), scale=gym.get_actor_scale(envs[1], 0),
                read=[read.mass, *read.com.to_list(), *np.ravel(read.inertia), read.flags],
                shapes=[shapes.friction, shapes.restitution])


@pytest.mark.parametrize("built_first", [False, True], ids=["queued", "after_build"])
def test_scale_shape_and_body_properties(built_first):
    got, want = both(_properties, built_first)
    for k, v in want["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
    assert_close(got["root"], want["root"], "root states")
    assert got["scale"] == want["scale"]
    np.testing.assert_allclose(got["read"], want["read"], rtol=0, atol=0)
    np.testing.assert_allclose(got["shapes"], want["shapes"], rtol=0, atol=0)
    p = got["params"]
    assert p["shape_size"][1, 0, 0] == pytest.approx(0.4)
    assert p["body_mass"][1, 0] == pytest.approx(p["body_mass"][0, 0] * 8.0)
    assert abs(got["root"][0, 2] - 1.0) < 1e-3  # env 0's ball floats (no gravity)
    assert got["root"][1, 2] < 0.9  # env 1's ball fell


def _build_overrides(gymapi, gymtorch, sim_kw):
    """Every kind of queued override, different in each env, applied at
    the build: the port writes each field once, the JAX facade one
    (env, actor) at a time."""
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, gymapi.SimParams(), **sim_kw)
    gym.add_ground(sim, gymapi.PlaneParams())
    opts = gymapi.AssetOptions(fix_base_link=True)
    arm = gym.load_asset(sim, STANDIN_ROOT, FRANKA_URDF, opts)
    ball = gym.create_sphere(sim, 0.1, gymapi.AssetOptions())
    rng = np.random.RandomState(5)
    for i in range(4):
        env = gym.create_env(sim, gymapi.Vec3(-1, -1, 0), gymapi.Vec3(1, 1, 2), 2)
        a = gym.create_actor(env, arm, gymapi.Transform(), "franka", i, 1)
        b = gym.create_actor(env, ball, gymapi.Transform(gymapi.Vec3(0.5, 0, 0.3)), "ball", i, 0)
        st = gym.get_actor_dof_states(env, a, gymapi.STATE_ALL)
        st["pos"] = rng.uniform(-0.5, 0.5, 9).astype(np.float32)
        st["vel"] = rng.uniform(-0.1, 0.1, 9).astype(np.float32)
        gym.set_actor_dof_states(env, a, st, gymapi.STATE_ALL)
        props = gym.get_actor_dof_properties(env, a)
        props["stiffness"] = rng.uniform(0, 100, 9)
        props["damping"] = rng.uniform(0, 10, 9)
        props["driveMode"][:] = i % 4
        gym.set_actor_dof_properties(env, a, props)
        gym.set_actor_dof_position_targets(env, a, rng.uniform(-1, 1, 9))
        gym.set_actor_dof_velocity_targets(env, a, rng.uniform(-1, 1, 9))
        gym.set_dof_target_position(env, gym.get_actor_dof_handle(env, a, 2), 0.25 * i)
        if i % 2:
            sp = gym.get_actor_rigid_shape_properties(env, b)
            sp[0].friction = 0.2 * i
            gym.set_actor_rigid_shape_properties(env, b, sp)
            bp = gym.get_actor_rigid_body_properties(env, a)
            for k, x in enumerate(bp):
                x.mass += 0.1 * k
            gym.set_actor_rigid_body_properties(env, a, bp)
            gym.set_actor_scale(env, b, 1.0 + 0.5 * i)
    sim._ensure_built()
    s = sim.sim
    out = {f"params.{k}": _np(v).copy() for k, v in s.params._asdict().items() if v is not None}
    out.update({f"state.{k}": _np(getattr(s.state, k)).copy() for k in (
        "dof_pos", "dof_vel", "body_pos", "body_quat", "body_linvel", "body_angvel")})
    out.update({f"actions.{k}": _np(getattr(s.actions, k)).copy() for k in (
        "dof_pos_target", "dof_vel_target")})
    return out


def test_queued_overrides_match_the_jax_facade():
    got, want = both(_build_overrides)
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("state.body"):
            assert_close(got[k], v, k)  # FK of the written DOF states
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# -- forces (examples/apply_forces.py:117) --------------------------------------
def _forces(gymapi, gymtorch, sim_kw, at_pos):
    gym, sim, envs = ball_scene(gymapi, sim_kw)
    gym.prepare_sim(sim)
    m = gym.get_actor_rigid_body_properties(envs[0], 0)[0].mass
    f = np.zeros((2, 3), np.float32)
    f[:, 2] = m * 9.8 * 2  # 2g upward
    if at_pos:
        pos = np.zeros((2, 3), np.float32)
        pos[:, 0] = 0.1  # off centre: a torque too
        pos[:, 2] = 1.0
        gym.apply_rigid_body_force_at_pos_tensors(sim, f, pos, gymapi.ENV_SPACE)
    else:
        t = np.zeros((2, 3), np.float32)
        t[0, 1] = 0.01
        gym.apply_rigid_body_force_tensors(sim, f, t, gymapi.ENV_SPACE)
    root = gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim))
    out = []
    for _ in range(2):  # the force acts on the next simulate only
        gym.simulate(sim)
        gym.refresh_actor_root_state_tensor(sim)
        out.append(_np(root).copy())
    gym.apply_body_forces(envs[1], 0, gymapi.Vec3(0, 0, m * 30.0), gymapi.Vec3(0.02, 0, 0))
    gym.simulate(sim)
    gym.refresh_actor_root_state_tensor(sim)
    out.append(_np(root).copy())
    return np.stack(out)


@pytest.mark.parametrize("at_pos", [False, True], ids=["force_torque", "at_position"])
def test_apply_rigid_body_forces(at_pos):
    got, want = both(_forces, at_pos)
    assert_close(got, want, "root states")
    assert got[0, 0, 9] > 0 and got[1, 0, 9] < got[0, 0, 9]  # up, then one-shot
    assert abs(got[0, 0, 10:13]).max() > 0  # the torque (or the lever) spun it
    assert got[2, 1, 9] > got[1, 1, 9]  # apply_body_forces


# -- cameras (test02:226-344, graphics.py) ---------------------------------------
def _cameras(gymapi, gymtorch, sim_kw):
    gym, sim, envs = ball_scene(gymapi, sim_kw)
    cams = []
    for env in envs:
        cam = gym.create_camera_sensor(env, gymapi.CameraProperties(width=64, height=48))
        gym.set_camera_location(cam, env, gymapi.Vec3(2, 0, 1), gymapi.Vec3(0, 0, 1))
        cams.append(cam)
    tex = gym.create_texture_from_buffer(sim, 4, 4, np.tile(
        np.array([255, 0, 0, 255, 0, 255, 0, 255], np.uint8), 8))
    gym.set_rigid_body_color(envs[1], 0, 0, gymapi.MESH_VISUAL, gymapi.Vec3(0.1, 0.2, 0.9))
    gym.render_all_camera_sensors(sim)
    out = {k: gym.get_camera_image(sim, envs[0], cams[0], kind) for k, kind in (
        ("color", gymapi.IMAGE_COLOR), ("depth", gymapi.IMAGE_DEPTH),
        ("seg", gymapi.IMAGE_SEGMENTATION))}
    out["color1"] = gym.get_camera_image(sim, envs[1], cams[1], gymapi.IMAGE_COLOR)
    gym.set_rigid_body_texture(envs[0], 0, 0, gymapi.MESH_VISUAL, tex)
    gym.set_rigid_body_segmentation_id(envs[0], 0, 0, 7)
    gym.set_light_parameters(sim, 0, gymapi.Vec3(0.9, 0.9, 0.9), gymapi.Vec3(0.1, 0.1, 0.1),
                             gymapi.Vec3(0.2, -0.3, -1.0))
    gym.set_camera_horizontal_fov(cams[0], envs[1], 60.0)
    gym.render_all_camera_sensors(sim)
    out["textured"] = gym.get_camera_image(sim, envs[0], cams[0], gymapi.IMAGE_COLOR)
    out["seg7"] = gym.get_camera_image(sim, envs[0], cams[0], gymapi.IMAGE_SEGMENTATION)
    out["zoomed"] = gym.get_camera_image(sim, envs[1], cams[0], gymapi.IMAGE_COLOR)
    out["gpu"] = _np(gymtorch.wrap_tensor(
        gym.get_camera_image_gpu_tensor(sim, envs[0], cams[0], gymapi.IMAGE_DEPTH))).copy()
    for _ in range(5):
        gym.simulate(sim)
    out["flow"] = gym.get_camera_image(sim, envs[0], cams[0], gymapi.IMAGE_OPTICAL_FLOW)
    out["P"] = gym.get_camera_proj_matrix(sim, envs[0], cams[0])
    out["V"] = gym.get_camera_view_matrix(sim, envs[0], cams[0])
    t = gym.get_camera_transform(sim, envs[0], cams[0])
    out["T"] = [*t.p.to_list(), *t.r.to_list()]
    out["rgb_of_body"] = gym.get_rigid_body_color(envs[1], 0, 0, gymapi.MESH_VISUAL).to_list()
    return out


def assert_frames_match(got_rgb, got_seg, want_rgb, want_seg, what, share=0.01):
    """render tests' rule for a frame: segmentation equal and colour within
    one count on all but `share` of the pixels."""
    seg_bad = got_seg != want_seg
    col_bad = np.abs(got_rgb.astype(np.int32) - want_rgb.astype(np.int32)).max(-1) > 1
    assert (seg_bad | col_bad).mean() <= share, (what, seg_bad.mean(), col_bad.mean())


def test_camera_images_and_matrices():
    got, want = both(_cameras)
    for k in ("color", "color1", "textured", "zoomed"):
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype == np.uint8, k
        g, w = got[k].reshape(48, 64, 4), want[k].reshape(48, 64, 4)
        assert_frames_match(g[..., :3], got["seg"], w[..., :3], want["seg"], k)
    np.testing.assert_array_equal(got["seg7"], want["seg7"])
    assert (got["seg7"] == 7).any()
    for k in ("depth", "gpu"):
        fin = np.isfinite(want[k])
        np.testing.assert_array_equal(np.isfinite(got[k]), fin)
        assert_close(got[k][fin], want[k][fin], k)
    assert_close(got["flow"], want["flow"], "optical flow")
    for k in ("P", "V", "T", "rgb_of_body"):
        assert_close(got[k], want[k], k, atol=1e-6)
    assert not np.array_equal(got["color"], got["textured"])  # the texture shows
    # the centre pixel sees the ball's front face 1.8 m ahead
    assert abs(-got["depth"][24, 32] - 1.8) < 0.05
    assert abs(got["T"][0] - 2) < 1e-5


def _attached_camera(gymapi, gymtorch, sim_kw):
    gym, sim, envs = ball_scene(gymapi, sim_kw)
    cam = gym.create_camera_sensor(envs[0], gymapi.CameraProperties(width=32, height=32))
    body = gym.get_actor_rigid_body_handle(envs[0], 0, 0)
    gym.attach_camera_to_body(
        cam, envs[0], body, gymapi.Transform(gymapi.Vec3(0, 0, 0.5)), gymapi.FOLLOW_TRANSFORM)
    gym.prepare_sim(sim)
    t0 = gym.get_camera_transform(sim, envs[0], cam)
    for _ in range(20):
        gym.simulate(sim)
    t1 = gym.get_camera_transform(sim, envs[0], cam)
    gym.render_all_camera_sensors(sim)
    return [t0.p.z, *t1.p.to_list(), *t1.r.to_list()], gym.get_camera_image(
        sim, envs[0], cam, gymapi.IMAGE_DEPTH)


def test_camera_attached_to_body():
    (got, gd), (want, wd) = both(_attached_camera)
    assert_close(got, want, "camera pose")
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    assert got[3] < got[0]  # followed the falling ball


# -- viewer + events (examples/projectiles.py:66-168) -----------------------------
def _viewer(gymapi, gymtorch, sim_kw):
    gym, sim, envs = ball_scene(gymapi, sim_kw)
    viewer = gym.create_viewer(sim, gymapi.CameraProperties())
    gym.subscribe_viewer_keyboard_event(viewer, gymapi.KEY_R, "reset")
    gym.subscribe_viewer_mouse_event(viewer, gymapi.MOUSE_LEFT_BUTTON, "shoot")
    out = [gym.query_viewer_has_closed(viewer)]
    viewer.inject_event(gymapi.KEY_R)
    viewer.inject_event(gymapi.MOUSE_LEFT_BUTTON, 0.5)
    out.append([(e.action, e.value) for e in gym.query_viewer_action_events(viewer)])
    out.append(gym.query_viewer_action_events(viewer))
    gym.viewer_camera_look_at(viewer, None, gymapi.Vec3(5, 5, 3), gymapi.Vec3(0, 0, 0))
    t = gym.get_viewer_camera_transform(viewer, None)
    out.append([*t.p.to_list(), *np.round(t.r.to_list(), 12)])
    size = gym.get_viewer_size(viewer)
    out.append((size.x, size.y))
    gym.draw_viewer(viewer, sim, True)
    out.append(viewer.frames)
    gym.destroy_viewer(viewer)
    out.append(gym.query_viewer_has_closed(viewer))
    return out


def test_viewer_headless_events():
    got, want = both(_viewer)
    assert got == want
    assert got[1] == [("reset", 1.0), ("shoot", 0.5)] and got[2] == []
    assert got[-1] is True


# -- gymutil ------------------------------------------------------------------------
def test_gymutil_parse_arguments():
    argv = ["--num_envs", "8", "--flex", "--pipeline", "cpu", "--sim_device", "cuda:1"]
    custom = [{"name": "--num_envs", "type": int, "default": 16, "help": "n"}]
    got = vars(gymutil.parse_arguments("t", True, custom_parameters=custom, args=argv))
    want = vars(jgymutil.parse_arguments("t", True, custom_parameters=custom, args=argv))
    assert got == want
    assert got["num_envs"] == 8 and got["physics_engine"] == gymapi.SIM_FLEX
    assert not got["use_gpu_pipeline"] and got["compute_device_id"] == 1
    assert gymutil.parse_arguments(args=[]).sim_device == "cuda:0"


def _geometry(gymapi, gymtorch, gymutil, sim_kw):
    gym, sim, envs = ball_scene(gymapi, sim_kw)
    cam = gym.create_camera_sensor(envs[1], gymapi.CameraProperties(width=64, height=48))
    gym.set_camera_location(cam, envs[1], gymapi.Vec3(1.5, 1.5, 1.5), gymapi.Vec3(0, 0, 0.5))
    viewer = gym.create_viewer(sim, gymapi.CameraProperties())
    pose = gymapi.Transform(gymapi.Vec3(0, 0, 0.5))
    geoms = [gymutil.AxesGeometry(0.5), gymutil.WireframeSphereGeometry(0.1, 4, 4, pose),
             gymutil.WireframeBoxGeometry(0.3, 0.2, 0.1, None, (0, 1, 0))]
    for g in geoms:
        gymutil.draw_lines(g, gym, viewer, envs[1])
    gymutil.draw_line(gymapi.Vec3(0, 0, 0), gymapi.Vec3(0.3, 0.3, 1.0), gymapi.Vec3(1, 1, 0),
                      gym, viewer, envs[1])
    gym.draw_env_rigid_contacts(viewer, envs[1], gymapi.Vec3(1, 0, 0), 0.1, True)
    lines = [(e, s.copy(), c.copy()) for e, s, c in viewer.lines]
    gym.render_all_camera_sensors(sim)
    img = gym.get_camera_image(sim, envs[1], cam, gymapi.IMAGE_COLOR).reshape(48, 64, 4)
    seg = gym.get_camera_image(sim, envs[1], cam, gymapi.IMAGE_SEGMENTATION)
    gym.clear_lines(viewer)
    gym.render_all_camera_sensors(sim)
    plain = gym.get_camera_image(sim, envs[1], cam, gymapi.IMAGE_COLOR).reshape(48, 64, 4)
    return [(g.num_lines, g.verts(), g.colors()) for g in geoms], lines, img, seg, plain, viewer.lines


def test_gymutil_geometry_and_debug_lines():
    (gg, gl, gi, gs, gp, gcleared) = _geometry(gymapi, gymtorch, gymutil, {"device": "cpu"})
    (wg, wl, wi, ws, wp, _) = _geometry(jgymapi, jgymtorch, jgymutil, {})
    for (gn, gv, gc), (wn, wv, wc) in zip(gg, wg):
        assert gn == wn
        assert_struct_equal(gv, wv, "verts")
        assert_struct_equal(gc, wc, "colors")
    assert len(gl) == len(wl) == 5
    for (ge, gsg, gcl), (we, wsg, wcl) in zip(gl, wl):
        assert ge == we == 1
        assert_close(gsg, wsg, "segments")
        np.testing.assert_array_equal(gcl, wcl)
    assert_frames_match(gi[..., :3], gs, wi[..., :3], ws, "lines drawn")
    assert_frames_match(gp[..., :3], gs, wp[..., :3], ws, "lines cleared")
    assert not np.array_equal(gi, gp) and gcleared == []


# -- terrain (examples/terrain_creation.py:99-119) ----------------------------------
def _terrain(gymapi, gymtorch, sim_kw, tu, trimesh):
    np.random.seed(17)
    sub = tu.SubTerrain(width=32, length=32, vertical_scale=0.005, horizontal_scale=0.25)
    hf = tu.pyramid_sloped_terrain(sub, slope=-0.5).height_field_raw
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, gymapi.SimParams(), **sim_kw)
    if trimesh:
        verts, tris = tu.convert_heightfield_to_trimesh(hf, 0.25, 0.005, slope_threshold=1.5)
        tm = gymapi.TriangleMeshParams()
        tm.nb_vertices, tm.nb_triangles = verts.shape[0], tris.shape[0]
        tm.transform.p.x = 0.0
        gym.add_triangle_mesh(sim, verts.flatten(), tris.flatten(), tm)
    else:
        hp = gymapi.HeightFieldParams()
        hp.column_scale = hp.row_scale = 0.25
        hp.vertical_scale = 0.005
        hp.nbRows, hp.nbColumns = hf.shape
        hp.transform.p.x = 0.5
        gym.add_heightfield(sim, hf, hp)
    ball = gym.create_sphere(sim, 0.2, gymapi.AssetOptions())
    env = gym.create_env(sim, gymapi.Vec3(0, 0, 0), gymapi.Vec3(8, 8, 4), 1)
    gym.create_actor(env, ball, gymapi.Transform(gymapi.Vec3(3.0, 4.0, 3.0)), "ball", 0, 0)
    root = gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim))
    for _ in range(150):
        gym.simulate(sim)
    gym.refresh_actor_root_state_tensor(sim)
    h = sim.sim.scene.heightfield
    return _np(root).copy(), np.asarray(h.data), (h.horizontal_scale, h.offset_x, h.offset_y)


@pytest.mark.parametrize("trimesh", [True, False], ids=["trimesh", "heightfield"])
def test_terrain_contact(trimesh):
    from test_isaacgym_tpu import terrain_utils as jtu
    from test_isaacgym_tpu_torch import terrain_utils as ttu

    got = _terrain(gymapi, gymtorch, {"device": "cpu"}, ttu, trimesh)
    want = _terrain(jgymapi, jgymtorch, {}, jtu, trimesh)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert_close(got[0], want[0], "ball root state")
    hs, ox, oy = got[2]
    i, j = (int(round((got[0][0, k] - o) / hs)) for k, o in ((0, ox), (1, oy)))
    assert 0 <= i < 32 and 0 <= j < 32  # stayed on the terrain (bowl)
    ground_z = float(got[1][i, j])
    assert ground_z - 0.05 < got[0][0, 2] < ground_z + 0.45


# -- soft bodies: tet and tri ranges, materials (soft_body.py:86-186) ---------------
def _soft(gymapi, gymtorch, sim_kw):
    gym = gymapi.acquire_gym()
    sp = gymapi.SimParams(dt=1 / 60, substeps=3, gravity=(0.0, -9.8, 0.0))
    sp.up_axis = gymapi.UP_AXIS_Y
    sim = gym.create_sim(0, 0, gymapi.SIM_FLEX, sp, **sim_kw)
    pp = gymapi.PlaneParams()
    pp.normal = gymapi.Vec3(0, 1, 0)
    gym.add_ground(sim, pp)
    asset = gym.load_asset(sim, ICOSPHERE_ROOT, ICOSPHERE_URDF,
                           gymapi.AssetOptions(fix_base_link=True, thickness=0.1))
    envs = []
    for i in range(2):
        env = gym.create_env(sim, gymapi.Vec3(-3, 0, -3), gymapi.Vec3(3, 3, 3), 1)
        gym.create_actor(env, asset, gymapi.Transform(gymapi.Vec3(0, 2.0, 0)), "soft", i, 1)
        gym.set_dof_target_position(env, gym.get_actor_dof_handle(env, 0, 0), 0.0)
        envs.append(env)
    mats = gym.get_actor_soft_materials(envs[1], 0)
    mats[0].youngs, mats[0].poissons = 2e5, 0.4
    ok = gym.set_actor_soft_materials(envs[1], 0, mats)
    tets, stress = gym.get_sim_tetrahedra(sim)
    tris, parents, normals = gym.get_sim_triangles(sim)
    r = [gym.get_actor_tetrahedra_range(envs[1], 0, 0), gym.get_actor_triangle_range(envs[1], 0, 0),
         gym.get_actor_tetrahedra_range(envs[1], 0, 5)]
    return dict(count=gym.get_asset_soft_body_count(asset), ok=ok,
                asset_mats=[(m.youngs, m.poissons, m.damping)
                            for m in gym.get_asset_soft_materials(asset)],
                mats=[(m.youngs, m.poissons, m.damping)
                      for e in envs for m in gym.get_actor_soft_materials(e, 0)],
                tets=tets, tris=tris, parents=parents, stress=np.array(stress),
                normals=np.array(normals), ranges=[(x.start, x.count) for x in r])


def test_soft_ranges_and_materials_on_the_icosphere():
    got, want = both(_soft)
    for k in ("count", "ok", "asset_mats", "tets", "tris", "parents", "ranges"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["mats"], want["mats"], rtol=1e-7)
    # at rest the stress is rounding noise of the Neo-Hookean terms, which
    # scale with Young's modulus: both packages' under 1e-5 of it
    # (tests/test_torch_soft.py holds tet_stress on deformed tets)
    assert got["stress"].shape == want["stress"].shape
    for x in (got["stress"], want["stress"]):
        assert np.abs(x).max() < 1e-5 * max(m[0] for m in got["mats"])
    assert_close(got["normals"], want["normals"], "tri normals")
    assert got["ranges"][0][1] > 0 and got["ranges"][2] == (0, 0)
    assert got["mats"][1][0] == pytest.approx(2e5)


# -- the texture reader: raises where it cannot read the file --------------------
def test_texture_from_file_raises_without_an_image_reader(monkeypatch, tmp_path):
    from test_isaacgym_tpu_torch.gymapi import facade

    img = np.zeros((4, 6, 4), np.uint8)
    img[..., 0] = 200
    img[..., 3] = 255
    path = tmp_path / "tex.png"
    from PIL import Image

    Image.fromarray(img).save(path)
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, gymapi.SimParams(), device="cpu")
    tex = gym.create_texture_from_file(sim, str(path))
    np.testing.assert_array_equal(sim.textures[tex], img)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    monkeypatch.setitem(__import__("sys").modules, "imageio", None)
    with pytest.raises(RuntimeError, match="neither is installed"):
        facade._load_texture(str(path))


# -- the card paths' scenes (envs/gym_scenes.py) against the JAX facade's goldens
# (tools/make_gym_goldens.py runs the same scenes through the JAX facade)
def _golden(name):
    import os

    from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT as root

    return np.load(os.path.join(os.path.dirname(root), name))


def test_gym_balls_scene_matches_the_jax_golden():
    """120 balls through gym calls (the sphere-world solve's plain version on
    the CPU), root positions every 10 steps to 60, and the KEY_R snapshot
    reset restoring the first state bit for bit."""
    from test_isaacgym_tpu_torch.envs import gym_scenes

    g = _golden("gym_balls_standin.npz")
    gym, sim, env = gym_scenes.balls(gymapi, 4, {"device": "cpu"})
    snapshot = np.copy(gym.get_sim_rigid_body_states(sim, gymapi.STATE_ALL))
    root = gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim))
    first = root.clone()
    every = int(g["every"])
    for k in range(len(g["pos"])):
        gym.refresh_actor_root_state_tensor(sim)
        assert_close(root[:, :3], g["pos"][k], f"positions at step {every * k}")
        for _ in range(every if k + 1 < len(g["pos"]) else 0):
            gym.simulate(sim)
    viewer = gym.create_viewer(sim, gymapi.CameraProperties())
    gym.subscribe_viewer_keyboard_event(viewer, gymapi.KEY_R, "reset")
    viewer.inject_event(gymapi.KEY_R)
    for ev in gym.query_viewer_action_events(viewer):
        if ev.action == "reset":
            gym.set_sim_rigid_body_states(sim, snapshot, gymapi.STATE_ALL)
    gym.refresh_actor_root_state_tensor(sim)
    assert torch.equal(root, first)


def test_gym_franka_osc_scene_matches_the_jax_golden():
    """examples/franka_osc.py's build and loop, 8 envs on the Panda stand-in:
    hand and DOF positions every 10 steps to 60 against the JAX facade's,
    and the example's mean tracking error after its 300 steps."""
    from test_isaacgym_tpu_torch.envs import gym_scenes

    g = _golden("gym_franka_osc_standin.npz")
    every = int(g["every"])
    gym, sim, scene = gym_scenes.franka_osc(gymapi, int(g["num_envs"]), sim_kw={"device": "cpu"})
    loop = gym_scenes.OscLoop(gym, gymapi, gymtorch, sim, scene)
    for itr in range(int(g["track_steps"])):
        if itr % every == 0 and itr // every < len(g["hand_pos"]):
            snap = loop.snapshot()
            for key in ("hand_pos", "dof_pos"):
                assert_close(snap[key], g[key][itr // every], f"{key} at step {itr}")
        loop.step(itr)
    assert_close(loop.mean_error(), g["track_err"], "mean tracking error")
    assert loop.mean_error() < 0.12  # the example's bound


def test_gym_interop_scene_matches_the_jax_frame():
    """examples/interop_torch.py's scene, 2 envs, 30 frames: env 0's colour
    image tensor against the JAX facade's frame, its data_address its
    data_ptr and aliasing the sensor's image across frames."""
    from test_isaacgym_tpu_torch.envs import gym_scenes

    g = _golden("gym_interop_standin.npz")
    gym, sim, envs, cams = gym_scenes.interop(gymapi, 2, {"device": "cpu"})
    gym.prepare_sim(sim)
    ptrs = set()
    for _ in range(int(g["frames"])):
        img = gym_scenes.interop_frame(gym, gymapi, gymtorch, sim, envs[0], cams[0])
        h = gym.get_camera_image_gpu_tensor(sim, envs[0], cams[0], gymapi.IMAGE_COLOR)
        assert h.data_address == img.data_ptr()
        ptrs.add(img.data_ptr())
    assert len(ptrs) == 1 and img.dtype == torch.uint8 and img.shape == (128, 128, 4)
    seg = gym.get_camera_image(sim, envs[0], cams[0], gymapi.IMAGE_SEGMENTATION)
    assert_frames_match(_np(img)[..., :3], seg, g["rgb"], g["seg"], "interop frame")
    assert (seg == 1).any()

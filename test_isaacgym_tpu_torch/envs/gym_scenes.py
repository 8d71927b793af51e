"""Scenes built through the gymapi facade: the reference's call patterns.

Each builder takes a package's `gymapi` module (and the loops its
`gymtorch`), so one definition builds the same scene through this port's
facade and, in the tests and tools/make_gym_goldens.py, through the JAX
package's. `sim_kw` goes to create_sim: {"device": ...} for the port, {}
for the JAX facade.

  * balls: the reference's 1080_balls_of_solitude.py --all_collisions as
    gym calls: envs/balls.py's layout (pyramids of 30 balls of radius 0.2,
    density 500, RandomState(17) jitter) in ONE env, dt 1/60, one substep,
    4 position and 1 velocity iterations; 1,080 balls at 36 pyramids, so
    the sphere-world solve runs (at least 64 spheres).
  * franka_osc: examples/franka_osc.py's scene (a fixed-base Panda per env,
    gravity off, arm DOFs in EFFORT mode, fingers PD-held) on the Panda
    stand-in, and `OscLoop`, its loop: the OSC torque from the wrapped
    rigid-body, DOF, Jacobian and mass-matrix tensors tracking a circle
    with the hand. The envs are laid out int(sqrt(N)) a row, as the
    reference's franka_osc.py lays them out.
  * interop: examples/interop_torch.py's scene: a ball per env over a
    ground, a 128 x 128 camera with enable_tensors in each env. The ball
    carries segmentation id 1.
"""
from __future__ import annotations

import numpy as np
import torch

from .balls import pyramid_positions
from .franka import FRANKA_URDF, STANDIN_ROOT

BALL_RADIUS, BALL_DENSITY = 0.2, 500.0
OSC_START = [0.0, 0.0, 0.0, -1.57, 0.0, 1.87, 0.0, 0.02, 0.02]
OSC_KP, OSC_KV = 5.0, 2.0 * np.sqrt(5.0)
OSC_SETTLE = 150  # the example averages the tracking error after this step
CAMERA_SIZE = 128


def balls(gymapi, pyramids=36, sim_kw=None):
    """(gym, sim, env) of the ball pyramids in one env, built by one
    create_env and a create_actor(env, ball, pose, name, 0, 0) a ball."""
    gym = gymapi.acquire_gym()
    sp = gymapi.SimParams(dt=1 / 60, substeps=1)
    sp.physx.num_position_iterations = 4
    sp.physx.num_velocity_iterations = 1
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, sp, **(sim_kw or {}))
    gym.add_ground(sim, gymapi.PlaneParams())
    opts = gymapi.AssetOptions()
    opts.density = BALL_DENSITY
    ball = gym.create_sphere(sim, BALL_RADIUS, opts)
    env = gym.create_env(sim, gymapi.Vec3(-8, -8, 0), gymapi.Vec3(8, 8, 8), 1)
    for k, p in enumerate(pyramid_positions(pyramids, radius=BALL_RADIUS)):
        gym.create_actor(env, ball, gymapi.Transform(gymapi.Vec3(*p)), f"ball{k}", 0, 0)
    return gym, sim, env


def franka_osc(gymapi, num_envs, asset_root=STANDIN_ROOT, sim_kw=None):
    """(gym, sim, scene dict) of examples/franka_osc.py's build: per env
    set_actor_dof_states, get/set_actor_dof_properties, the hand's pose by
    get_rigid_transform (the pre-build FK) and its index by
    find_actor_rigid_body_index. The dict holds the asset, the hand's sim
    body indices and its initial env-local positions (N, 3)."""
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, gymapi.SimParams(), **(sim_kw or {}))
    gym.add_ground(sim, gymapi.PlaneParams())
    opts = gymapi.AssetOptions(fix_base_link=True)
    opts.disable_gravity = True
    franka = gym.load_asset(sim, asset_root, FRANKA_URDF, opts)
    default_dof = np.zeros(9, gymapi.DofState.dtype)
    default_dof["pos"] = OSC_START
    per_row = max(int(np.sqrt(num_envs)), 1)
    hand_idxs, init_pos = [], []
    for i in range(num_envs):
        env = gym.create_env(sim, gymapi.Vec3(-1, -1, 0), gymapi.Vec3(1, 1, 2), per_row)
        a = gym.create_actor(env, franka, gymapi.Transform(), "franka", i, 1)
        gym.set_actor_dof_states(env, a, default_dof, gymapi.STATE_ALL)
        props = gym.get_actor_dof_properties(env, a)
        props["driveMode"][:7] = gymapi.DOF_MODE_EFFORT
        props["stiffness"][:7] = 0.0
        props["damping"][:7] = 0.0
        props["driveMode"][7:] = gymapi.DOF_MODE_POS
        props["stiffness"][7:] = 800.0
        props["damping"][7:] = 40.0
        gym.set_actor_dof_properties(env, a, props)
        hand = gym.find_actor_rigid_body_handle(env, a, "panda_hand")
        pose = gym.get_rigid_transform(env, hand)
        init_pos.append([pose.p.x, pose.p.y, pose.p.z])
        hand_idxs.append(gym.find_actor_rigid_body_index(env, a, "panda_hand", gymapi.DOMAIN_SIM))
    return gym, sim, dict(asset=franka, hand_idxs=hand_idxs, init_pos=np.array(init_pos))


class OscLoop:
    """examples/franka_osc.py's loop on a franka_osc sim: the wrapped
    tensors, acquired once, and `step(itr)`, one iteration (refresh the
    four tensors, the OSC torque, set_dof_actuation_force_tensor, simulate).
    The tracking error after OSC_SETTLE is summed where the tensors live,
    without a host read a step (`mean_error` reads it once)."""

    def __init__(self, gym, gymapi, gymtorch, sim, scene):
        self.gym, self.gymtorch, self.sim = gym, gymtorch, sim
        gym.prepare_sim(sim)
        self.rb = gymtorch.wrap_tensor(gym.acquire_rigid_body_state_tensor(sim))
        self.dof = gymtorch.wrap_tensor(gym.acquire_dof_state_tensor(sim))
        self.jac = gymtorch.wrap_tensor(gym.acquire_jacobian_tensor(sim, "franka"))
        self.mm = gymtorch.wrap_tensor(gym.acquire_mass_matrix_tensor(sim, "franka"))
        dev = self.rb.device
        self.n = len(scene["hand_idxs"])
        self.hand = torch.as_tensor(scene["hand_idxs"], device=dev)
        self.hand_row = gym.get_asset_rigid_body_dict(scene["asset"])["panda_hand"] - 1
        self.init_pos = torch.as_tensor(scene["init_pos"], dtype=torch.float32, device=dev)
        self.err_sum = torch.zeros((), device=dev)
        self.err_steps = 0

    def refresh(self):
        g, s = self.gym, self.sim
        g.refresh_rigid_body_state_tensor(s)
        g.refresh_dof_state_tensor(s)
        g.refresh_jacobian_tensors(s)
        g.refresh_mass_matrix_tensors(s)

    def torque(self, itr):
        """(pos_des, pos_cur, u) of iteration itr from the refreshed tensors."""
        n, dev = self.n, self.rb.device
        pos_cur = self.rb[self.hand, :3]
        pos_des = self.init_pos.clone()
        pos_des[:, 0] -= 0.1
        pos_des[:, 1] += np.sin(itr / 50) * 0.15
        pos_des[:, 2] += np.cos(itr / 50) * 0.15
        j_eef = self.jac[:, self.hand_row, :, :7]
        mm7 = self.mm[:, :7, :7]
        dof_vel = self.dof.view(n, 9, 2)[:, :7, 1:2]
        m_inv = torch.inverse(mm7)
        m_eef = torch.inverse(j_eef @ m_inv @ j_eef.transpose(1, 2))
        dpose = torch.zeros(n, 6, 1, device=dev)
        dpose[:, :3, 0] = OSC_KP * (pos_des - pos_cur)
        u7 = j_eef.transpose(1, 2) @ m_eef @ (OSC_KP * dpose) - OSC_KV * mm7 @ dof_vel
        u = torch.zeros(n, 9, device=dev)
        u[:, :7] = u7.squeeze(-1)
        return pos_des, pos_cur, u

    def step(self, itr, fetch=True):
        self.refresh()
        pos_des, pos_cur, u = self.torque(itr)
        self.gym.set_dof_actuation_force_tensor(self.sim, self.gymtorch.unwrap_tensor(u))
        self.gym.simulate(self.sim)
        if fetch:
            self.gym.fetch_results(self.sim, True)
        if itr > OSC_SETTLE:
            self.err_sum += (pos_des - pos_cur).norm(dim=1).mean()
            self.err_steps += 1

    def mean_error(self) -> float:
        return float(self.err_sum) / max(self.err_steps, 1)

    def snapshot(self) -> dict:
        """Hand positions (N, 3) and DOF positions (N, 9), refreshed, as numpy
        copies (the wrapped tensors are refreshed in place)."""
        self.refresh()
        return {"hand_pos": np.array(self.rb[self.hand, :3].cpu()),
                "dof_pos": np.array(self.dof.view(self.n, 9, 2)[..., 0].cpu())}


def interop(gymapi, num_envs, sim_kw=None):
    """(gym, sim, envs, cams) of examples/interop_torch.py's scene."""
    gym = gymapi.acquire_gym()
    params = gymapi.SimParams()
    params.use_gpu_pipeline = True  # interop_torch.py:47 forces it
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, params, **(sim_kw or {}))
    gym.add_ground(sim, gymapi.PlaneParams())
    opts = gymapi.AssetOptions()
    opts.density = 200.0
    ball = gym.create_sphere(sim, 0.2, opts)
    envs, cams = [], []
    for i in range(num_envs):
        env = gym.create_env(sim, gymapi.Vec3(-1, -1, 0), gymapi.Vec3(1, 1, 2), 2)
        gym.create_actor(env, ball, gymapi.Transform(gymapi.Vec3(0, 0, 1.0)), "ball", i, 0, 1)
        cam_props = gymapi.CameraProperties(width=CAMERA_SIZE, height=CAMERA_SIZE,
                                            enable_tensors=True)
        cam = gym.create_camera_sensor(env, cam_props)
        gym.set_camera_location(cam, env, gymapi.Vec3(1.5, 0, 1), gymapi.Vec3(0, 0, 0.6))
        envs.append(env)
        cams.append(cam)
    return gym, sim, envs, cams


def interop_frame(gym, gymapi, gymtorch, sim, env, cam):
    """One frame of examples/interop_torch.py's loop: simulate, render,
    and env `env`'s colour image tensor between start/end_access."""
    gym.simulate(sim)
    gym.fetch_results(sim, True)
    gym.step_graphics(sim)
    gym.render_all_camera_sensors(sim)
    gym.start_access_image_tensors(sim)
    img = gymtorch.wrap_tensor(gym.get_camera_image_gpu_tensor(sim, env, cam, gymapi.IMAGE_COLOR))
    gym.end_access_image_tensors(sim)
    return img

"""Gym-style vectorized RL wrapper: the isaacgymenvs.make surface.

Port of test_isaacgym_tpu/envs/rl_env.py. The reference's RL stack wraps
envs as `isaacgymenvs.make(task=..., num_envs=...)` with `reset() -> obs`,
`step(actions) -> (obs, reward, done, info)`, `render(mode="rgb_array") ->
(H, W, 3)`, `action_space.shape` and `is_vector_env` (its
common/capture_videos.py:6-31). Here the same surface fronts the batched
Simulator: one step runs control + physics for every env as eager PyTorch
ops on the env's device, and `render()` ray-casts a viewer-style camera over
env 0 (render/raster.py).

`reset` and `step` return tensors on `rl_device` (isaacgymenvs' own
surface), never numpy: a step makes no host sync. The JAX package's step
returns numpy arrays. `render` returns a numpy frame.

Tasks:
  * "Ant"    — nv_ant MJCF (the Ant stand-in committed in this package by
               default, assets/data/ant_standin), floating base,
               torque-controlled joints, forward-velocity reward, fall
               termination + reset.
  * "Franka" — fixed-base arm (the Panda stand-in), position-drive deltas,
               reach reward.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..assets.types import DOF_MODE_EFFORT
from ..core.state import SimState

ASSET_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "data", "ant_standin"
)


class _Space(NamedTuple):
    shape: tuple
    low: float
    high: float

    def sample(self, rng=None):
        rng = rng or np.random
        return rng.uniform(self.low, self.high, self.shape).astype(np.float32)


def make(
    seed: int = 0,
    task: str = "Ant",
    num_envs: int = 20,
    sim_device: str = "cuda:0",
    rl_device: str = "cuda:0",
    graphics_device_id: int = 0,
    headless: bool = True,
    multi_gpu: bool = False,
    virtual_screen_capture: bool = False,
    force_render: bool = False,
):
    """isaacgymenvs.make-shaped constructor (capture_videos.py:6-16). The
    envs run on `sim_device` and hand their tensors out on `rl_device`;
    "cpu" is accepted for both."""
    if task == "Ant":
        env = AntVecEnv(num_envs=num_envs, seed=seed, device=sim_device)
    elif task == "Franka":
        env = FrankaReachVecEnv(num_envs=num_envs, seed=seed, device=sim_device)
    else:
        raise ValueError(f"unknown task {task!r} (have: Ant, Franka)")
    env.rl_device = torch.device(rl_device)
    return env


class _VecEnvBase:
    is_vector_env = True

    def __init__(self, num_envs=20, seed=0, device="cuda"):
        self.num_envs = num_envs
        self.seed = seed
        self.device = torch.device(device)
        self.rl_device = self.device
        self._rtables = None

    # -- gym surface --------------------------------------------------------
    def reset(self):
        self.state = self.sim.initial_state
        return self._obs(self.state).to(self.rl_device)

    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        self.state, obs, reward, done = self._step(self.state, actions)
        out = self.rl_device
        return obs.to(out), reward.to(out), done.to(out), {}

    def render(self, mode="rgb_array"):
        """Viewer-style image of env 0 (capture_videos.py:26-29), a numpy
        (240, 320, 3) uint8 frame."""
        return self.camera_images()[0][..., :3].cpu().numpy()

    def camera_images(self, seg=None):
        """(rgba (240, 320, 4) uint8, depth, seg) tensors of render()'s
        camera over env 0; `seg` (S,) replaces the scene's segmentation ids
        (a per-shape id shows which shape each pixel hits)."""
        from ..render.camera import look_at_quat
        from ..render.raster import render_camera_batch, shape_world_poses, tables_from_scene

        if self._rtables is None:
            self._rtables = tables_from_scene(self.sim.scene, self.device)
        p, tb = self.sim.params, self._rtables
        sp, sq = shape_world_poses(self.state, p, tb, self.sim.scene)
        eye, target = self._camera()
        quat = look_at_quat(eye, target)
        dev = self.device
        rgba, depth, seg_img, _ = render_camera_batch(
            torch.as_tensor(np.asarray(eye, np.float32), device=dev)[None],
            torch.as_tensor(np.asarray(quat, np.float32), device=dev)[None],
            sp[:1],
            sq[:1],
            p.shape_size[:1],
            tb.kind,
            tb.color,
            tb.seg if seg is None else seg,
            np.array([0, 0, 1, 0], np.float32),
            np.array([-0.3, -0.3, -0.9], np.float32) / np.linalg.norm([0.3, 0.3, 0.9]),
            np.array([0.8, 0.8, 0.8], np.float32),
            np.array([0.25, 0.25, 0.25], np.float32),
            np.array([0.32, 0.45, 0.6], np.float32),
            90.0,
            width=320,
            height=240,
            far=100.0,
        )
        return rgba[0], depth[0], seg_img[0]


def _reset_where(done, init: SimState, st: SimState) -> SimState:
    """init's value wherever `done`, in every field whose leading axis is
    done's (the JAX env's tree map); other fields (the clock) stay."""

    def sel(i, s):
        if s is None or s.dim() == 0 or s.shape[:1] != done.shape:
            return s
        return torch.where(done.reshape(done.shape + (1,) * (s.dim() - 1)), i, s)

    return SimState(*[sel(i, s) for i, s in zip(init, st)])


class AntVecEnv(_VecEnvBase):
    """nv_ant locomotion: obs = [root h, root quat, lin/ang vel, dof pos/vel],
    reward = forward velocity + alive bonus - control cost, done on fall."""

    def __init__(self, num_envs=20, seed=0, device="cuda"):
        super().__init__(num_envs=num_envs, seed=seed, device=device)
        from ..assets import load_mjcf
        from ..core.config import PlaneParams, SimParams
        from ..core.scene import SceneBuilder
        from ..core.sim import Simulator

        dev = self.device
        sp = SimParams(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, -9.8))
        sp.physx.num_position_iterations = 4
        ant = load_mjcf(ASSET_ROOT, "mjcf/nv_ant.xml")
        b = SceneBuilder(sp)
        b.add_ground(PlaneParams())
        n_row = max(int(np.sqrt(num_envs)), 1)
        for i in range(num_envs):
            b.create_env((-2, -2, 0), (2, 2, 1), n_row)
            b.create_actor(i, ant, pos=(0, 0, 0.55), name="ant", group=i, filter=0)
        self.sim = Simulator(*b.finalize(dev), device=dev)
        meta = self.sim.scene.find_actor("ant")
        self.slot = meta.slot
        self.dof_sl = slice(meta.dof_start, meta.dof_start + meta.dof_count)
        self.nd = meta.dof_count
        p = self.sim.params
        mode, effort = p.dof_drive_mode.clone(), p.dof_max_effort.clone()
        mode[:, self.dof_sl] = DOF_MODE_EFFORT
        effort[:, self.dof_sl] = 30.0
        self.sim.params = p._replace(dof_drive_mode=mode, dof_max_effort=effort)
        self.action_space = _Space((self.nd,), -1.0, 1.0)
        self.observation_space = _Space((11 + 2 * self.nd,), -np.inf, np.inf)
        self.state = self.sim.initial_state

    def _obs(self, st):
        s = self.slot
        return torch.cat([st.root_pos[:, s, 2:3], st.root_quat[:, s], st.root_linvel[:, s],
                          st.root_angvel[:, s], st.dof_pos[:, self.dof_sl],
                          st.dof_vel[:, self.dof_sl]], dim=-1)

    def _camera(self):
        root = self.state.root_pos[0, self.slot].cpu().numpy()
        return root + np.array([-1.5, -1.5, 1.0]), root

    def _step(self, st, actions):
        a = self.sim.actions
        effort = a.dof_effort.clone()
        effort[:, self.dof_sl] = actions.clamp(-1, 1) * 30.0
        st = self.sim.stepper.step(st, a._replace(dof_effort=effort), self.sim.params)
        h = st.root_pos[:, self.slot, 2]
        vx = st.root_linvel[:, self.slot, 0]
        reward = vx + 0.5 - 0.005 * (actions ** 2).sum(-1)
        done = h < 0.25
        # auto-reset fallen envs (vectorized-env semantics)
        st = _reset_where(done, self.sim.initial_state, st)
        return st, self._obs(st), reward, done


class FrankaReachVecEnv(_VecEnvBase):
    """Franka arm position-delta control toward a fixed goal; reward =
    -|hand - goal|."""

    def __init__(self, num_envs=20, seed=0, device="cuda"):
        super().__init__(num_envs=num_envs, seed=seed, device=device)
        from .franka import FrankaOscEnv

        self.env = FrankaOscEnv(num_envs=num_envs, device=device)
        self.sim = self.env.sim
        self.nd = 7
        self.action_space = _Space((self.nd,), -1.0, 1.0)
        self.observation_space = _Space((14,), -np.inf, np.inf)
        self.goal = torch.tensor([0.5, 0.0, 0.5], device=self.device).repeat(num_envs, 1)
        self.state = self.sim.initial_state

    def _obs(self, st):
        return torch.cat([st.dof_pos[:, :7], st.dof_vel[:, :7]], dim=-1)

    def _camera(self):
        return np.array([1.5, 0.0, 0.8]), np.array([0.3, 0.0, 0.4])

    def _step(self, st, actions):
        a = self.sim.actions
        tgt = a.dof_pos_target.clone()
        tgt[:, :7] = st.dof_pos[:, :7] + 0.05 * actions.clamp(-1, 1)
        st = self.sim.stepper.step(st, a._replace(dof_pos_target=tgt), self.sim.params)
        hand = st.body_pos[:, self.env.hand_body]
        reward = -torch.linalg.vector_norm(hand - self.goal, dim=-1)
        done = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        return st, self._obs(st), reward, done

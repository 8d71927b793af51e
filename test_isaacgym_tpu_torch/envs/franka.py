"""Flagship batched Franka env: OSC circle tracking.

Port of test_isaacgym_tpu/envs/franka.py. Mirrors the reference's
examples/franka_osc.py: a fixed-base Franka per env, arm dofs in EFFORT mode
driven by an OSC torque tracking a circle with the hand, grippers in POS
mode. Control and physics run as eager PyTorch ops on `device`.

`asset_root` defaults to the mesh-free Panda stand-in committed in this
package (assets/data/panda_standin: the Panda's tree, published kinematics
and identified inertials, no geometry). The real franka_description asset
has meshes, which the port's URDF importer does not read yet.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..assets import load_urdf
from ..assets.types import DOF_MODE_EFFORT, DOF_MODE_POS
from ..control.osc import orientation_error
from ..core.config import SimParams
from ..core.scene import SceneBuilder
from ..core.sim import Simulator
from ..core.state import SimState
from ..utils.linalg import spd_solve
from ..utils.trace import span

STANDIN_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "data", "panda_standin",
)
FRANKA_URDF = "urdf/franka_description/robots/franka_panda.urdf"

# mid-range default pose (franka_osc.py:95-97 uses joint mids)
DEFAULT_DOF_POS = np.array(
    [0.0, 0.0, 0.0, -1.57, 0.0, 1.87, 0.0, 0.02, 0.02], np.float32
)


@dataclasses.dataclass
class FrankaOscEnv:
    num_envs: int = 256
    kp: float = 5.0
    kv: float = 2.0 * np.sqrt(5.0)  # franka_osc.py:189-190
    asset_root: str = STANDIN_ROOT
    device: str = "cuda"

    def __post_init__(self):
        dev = torch.device(self.device)
        sp = SimParams(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, -9.8))
        asset = load_urdf(
            self.asset_root, FRANKA_URDF, fix_base_link=True, armature=0.01
        )
        asset.disable_gravity = True  # franka_osc.py:82
        b = SceneBuilder(sp)
        n_row = max(int(np.sqrt(self.num_envs)), 1)
        for i in range(self.num_envs):
            b.create_env((-1, -1, 0), (1, 1, 1), n_row)
            b.create_actor(i, asset, pos=(0, 0, 0), name="franka", group=i, filter=1)
        self.sim = Simulator(*b.finalize(dev), device=dev)
        scene = self.sim.scene

        # control properties: arm EFFORT, grippers POS (franka_osc.py:99-107)
        stiff = np.zeros((self.num_envs, 9), np.float32)
        damp = np.zeros((self.num_envs, 9), np.float32)
        mode = np.zeros((self.num_envs, 9), np.int32)
        mode[:, :7] = DOF_MODE_EFFORT
        mode[:, 7:] = DOF_MODE_POS
        stiff[:, 7:] = 800.0
        damp[:, 7:] = 40.0
        self.sim.params = self.sim.params._replace(
            dof_stiffness=torch.as_tensor(stiff, device=dev),
            dof_damping=torch.as_tensor(damp, device=dev),
            dof_drive_mode=torch.as_tensor(mode, device=dev),
        )
        # default dof state
        self._default_dof_pos = torch.as_tensor(DEFAULT_DOF_POS, device=dev)
        q0 = self._default_dof_pos.repeat(self.num_envs, 1)
        self.sim.state = self.sim.state._replace(dof_pos=q0)
        self.sim.state = self.sim.stepper.refresh_body_state(
            self.sim.state, self.sim.params
        )
        self.sim.initial_state = self.sim.state

        meta = scene.find_actor("franka")
        self.hand_body = meta.body_start + asset.rigid_body_dict()["panda_hand"]
        self._hand_jac_fn = self.sim.body_jacobian_fn("franka", "panda_hand")
        self._mm_fn = self.sim.mass_matrix_fn("franka")

        # initial hand pose defines the circle center (env-local + origins,
        # matching franka_osc.py's env-local init_pos + absolute sin/cos target)
        st = self.sim.state
        self.origins = torch.as_tensor(scene.env_origins, dtype=torch.float32, device=dev)
        self.init_hand_pos = st.body_pos[:, self.hand_body]
        self.init_hand_quat = st.body_quat[:, self.hand_body]

    # ------------------------------------------------------------------
    def _control(self, state: SimState, itr, refs=None, params=None):
        """OSC torque for circle tracking (franka_osc.py:215-245 semantics).

        itr: the step count as a tensor (state.steps). refs =
        (init_hand_pos, init_hand_quat, origins), passed explicitly so that a
        step on a shard of the envs reads its shard's targets (default: the
        env's full-width ones); `params` feeds the runtime mass matrix's body
        params."""
        with span("control.osc"):
            init_hand_pos, init_hand_quat, origins = (
                refs if refs is not None
                else (self.init_hand_pos, self.init_hand_quat, self.origins)
            )
            with span("control.osc.jacobian"):
                j_eef = self._hand_jac_fn(state)[:, :, :7]  # (N, 6, 7)
            with span("control.osc.mass_matrix"):
                mm = self._mm_fn(state, params)  # (N, 9, 9)
            mm77 = mm[:, :7, :7]

            hand_pos = state.body_pos[:, self.hand_body]
            hand_quat = state.body_quat[:, self.hand_body]

            t = itr.to(torch.float32)
            pos_des = torch.stack(
                [
                    init_hand_pos[:, 0] - 0.1,
                    origins[:, 1] + torch.sin(t / 50.0) * 0.2,
                    init_hand_pos[:, 2] + torch.cos(t / 50.0) * 0.2,
                ],
                dim=-1,
            )
            orn_err = orientation_error(init_hand_quat, hand_quat)
            pos_err = self.kp * (pos_des - hand_pos)
            dpose = torch.cat([pos_err, orn_err], dim=-1)

            jt = j_eef.transpose(-1, -2)
            m_eef_inv = j_eef @ spd_solve(mm77, jt)  # (N, 6, 6)
            dof_vel = state.dof_vel[:, :7]
            u = (
                jt @ spd_solve(m_eef_inv, self.kp * dpose)[..., None]
                - self.kv * (mm77 @ dof_vel[..., None])
            )[..., 0]
            effort = torch.cat([u, torch.zeros_like(u[:, :2])], dim=-1)
            pos_target = torch.zeros_like(effort) + self._default_dof_pos
            return effort, pos_target

    def _step_impl(self, state, actions, params, itr, refs=None):
        effort, pos_target = self._control(state, itr, refs, params)
        actions = actions._replace(dof_effort=effort, dof_pos_target=pos_target)
        return self.sim.stepper.step(state, actions, params)

    # ------------------------------------------------------------------
    def step(self):
        self.sim.state = self._step_impl(
            self.sim.state, self.sim.actions, self.sim.params, self.sim.state.steps
        )

    def rollout_fn(self, num_steps: int):
        """A callable state -> state after num_steps control+physics steps."""
        actions = self.sim.actions
        params = self.sim.params

        def run(state: SimState) -> SimState:
            for _ in range(num_steps):
                state = self._step_impl(state, actions, params, state.steps)
            return state

        return run

    @property
    def hand_pos(self):
        return self.sim.state.body_pos[:, self.hand_body]

    def tracking_error(self, itr: int):
        """Per-env distance (numpy) of the hand from the circle target at
        step `itr`."""
        t = float(itr)
        init = self.init_hand_pos.cpu().numpy()
        pos_des = np.stack(
            [
                init[:, 0] - 0.1,
                self.origins[:, 1].cpu().numpy() + np.sin(t / 50.0) * 0.2,
                init[:, 2] + np.cos(t / 50.0) * 0.2,
            ],
            axis=-1,
        )
        return np.linalg.norm(self.hand_pos.cpu().numpy() - pos_des, axis=-1)

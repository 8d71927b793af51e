"""Batched Franka cube pick: IK/OSC grasp state machine.

Port of test_isaacgym_tpu/envs/franka_cube.py, the counterpart of the
reference's examples/franka_cube_ik_osc.py (envs grasping randomized cubes
off a table): damped-least-squares IK or OSC task-space control (:53-79),
the tensor-conditional grasp state machine (:336-406) as torch.where logic,
and gripper-link contact carrying the cube. Control and physics run as
eager PyTorch ops on `device`, with no host sync in a step.

Scene constants mirror the reference (:153-260): 0.6x1.0x0.4 table at
x=0.5, 0.045 cube randomized on it, franka at the origin, stiffness 400/80
drives for IK, effort mode for OSC.

`asset_root` defaults to the Panda stand-in committed in this package
(assets/data/panda_standin), loaded from `franka_panda_boxes.urdf`: the
mesh-free stand-in of envs/franka.py with collision boxes on the hand and
fingers. The real franka_description has collision meshes (convex hulls),
which the port does not read yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..assets import load_urdf
from ..assets.primitives import create_box
from ..assets.types import DOF_MODE_EFFORT, DOF_MODE_POS
from ..control.osc import control_ik, orientation_error
from ..core.config import PlaneParams, SimParams
from ..core.scene import SceneBuilder
from ..core.sim import Simulator
from ..core.state import SimState
from ..math.quat import quat_conjugate, quat_mul, quat_rotate
from ..utils.linalg import spd_solve
from .franka import STANDIN_ROOT

FRANKA_URDF = "urdf/franka_description/robots/franka_panda_boxes.urdf"

TABLE_DIMS = (0.6, 1.0, 0.4)
BOX_SIZE = 0.045


def _box_grasp_yaw(box_quat, x_axis):
    """Yaw quaternion of the nearest graspable cube face (the reference's
    cube_grasping_yaw helper): cube x-axis heading folded into [-pi/4, pi/4]."""
    ax = quat_rotate(box_quat, x_axis)
    yaw = torch.atan2(ax[..., 1], ax[..., 0])
    yaw = yaw - torch.round(yaw / (math.pi / 2)) * (math.pi / 2)
    half = yaw / 2
    z = torch.zeros_like(half)
    return torch.stack([z, z, torch.sin(half), torch.cos(half)], dim=-1)


def _yaw_quat(yaw):
    return (0.0, 0.0, float(np.sin(yaw / 2)), float(np.cos(yaw / 2)))


class PickState(NamedTuple):
    sim: SimState
    hand_restart: torch.Tensor  # (N,) bool


@dataclasses.dataclass
class FrankaCubeEnv:
    num_envs: int = 16
    controller: str = "ik"  # "ik" | "osc"
    seed: int = 42  # the reference seeds 42 (:83)
    ik_damping: float = 0.05
    osc_kp: float = 150.0
    asset_root: str = STANDIN_ROOT
    device: str = "cuda"

    def __post_init__(self):
        dev = torch.device(self.device)
        sp = SimParams(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, -9.8))
        sp.physx.num_position_iterations = 8
        franka = load_urdf(self.asset_root, FRANKA_URDF, fix_base_link=True, armature=0.01)
        franka.disable_gravity = True
        table = create_box(*TABLE_DIMS, fix_base_link=True)
        cube = create_box(BOX_SIZE, BOX_SIZE, BOX_SIZE, density=400.0)

        rng = np.random.RandomState(self.seed)
        b = SceneBuilder(sp)
        b.add_ground(PlaneParams())  # the reference's :232-235
        n_row = max(int(np.sqrt(self.num_envs)), 1)
        for i in range(self.num_envs):
            b.create_env((-1, -1, 0), (1, 1, 1.5), n_row)
            b.create_actor(
                i, table, pos=(0.5, 0.0, 0.5 * TABLE_DIMS[2]), name="table",
                group=i, filter=0,
            )
            b.create_actor(
                i, cube,
                pos=(
                    0.5 + rng.uniform(-0.1, 0.1),
                    rng.uniform(-0.2, 0.2),
                    TABLE_DIMS[2] + 0.5 * BOX_SIZE,
                ),
                quat=_yaw_quat(rng.uniform(-np.pi, np.pi)),
                name="box", group=i, filter=0,
            )
            b.create_actor(i, franka, pos=(0, 0, 0), name="franka", group=i, filter=2)
        self.sim = Simulator(*b.finalize(dev), device=dev)
        scene = self.sim.scene

        meta = scene.find_actor("franka")
        self.box_slot = scene.find_actor("box").slot
        self.hand_body = meta.body_start + franka.rigid_body_dict()["panda_hand"]
        self.dof0 = meta.dof_start
        self._hand_jac = self.sim.body_jacobian_fn("franka", "panda_hand")
        self._mm = self.sim.mass_matrix_fn("franka")

        # drive modes (the reference's :183-191): IK -> stiff position
        # drives; OSC -> zero-gain effort on the arm. Grippers always POS.
        stiff = np.zeros((self.num_envs, 9), np.float32)
        damp = np.zeros((self.num_envs, 9), np.float32)
        mode = np.zeros((self.num_envs, 9), np.int32)
        if self.controller == "ik":
            mode[:, :7] = DOF_MODE_POS
            stiff[:, :7] = 400.0
            damp[:, :7] = 80.0
        else:
            mode[:, :7] = DOF_MODE_EFFORT
        mode[:, 7:] = DOF_MODE_POS
        stiff[:, 7:] = 800.0
        damp[:, 7:] = 40.0
        sl = slice(self.dof0, self.dof0 + 9)
        p = self.sim.params

        def put(full, part):
            full = full.clone()
            full[:, sl] = torch.as_tensor(part, device=dev)
            return full

        self.sim.params = p._replace(
            dof_stiffness=put(p.dof_stiffness, stiff),
            dof_damping=put(p.dof_damping, damp),
            dof_drive_mode=put(p.dof_drive_mode, mode),
        )
        # default pose = joint-limit mids, grippers open (the reference's :195-198)
        lo = self.sim.params.dof_lower[0, sl].cpu().numpy()
        hi = self.sim.params.dof_upper[0, sl].cpu().numpy()
        mids = 0.5 * (lo + hi)
        mids[7:] = hi[7:]
        st = self.sim.state
        st = st._replace(dof_pos=put(st.dof_pos, np.tile(mids, (self.num_envs, 1))))
        self.sim.state = self.sim.stepper.refresh_body_state(st, self.sim.params)
        self.sim.initial_state = self.sim.state

        self.init_hand_pos = self.sim.state.body_pos[:, self.hand_body]
        self.init_hand_quat = self.sim.state.body_quat[:, self.hand_body]
        self.grasp_offset = 0.11 if self.controller == "ik" else 0.10
        self.init_state = PickState(
            sim=self.sim.state,
            hand_restart=torch.zeros(self.num_envs, dtype=torch.bool, device=dev),
        )
        # constants of the step, on the device once
        self._x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
        self._down = torch.tensor([0.0, 0.0, -1.0], device=dev)
        # hand pointing straight down (the reference's down_q, :295)
        self._down_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self._dof = torch.arange(self.dof0, self.dof0 + 9, device=dev)

    # ------------------------------------------------------------------
    def step_fn(self, state: PickState, _=None):
        """Grasp FSM + task-space control + physics (the reference's
        :336-410). Returns (next PickState, (gripped (N,), box z (N,))); the
        unused second argument is a scan's per-step input."""
        actions, hand_restart, gripped, box_z = self.control(state)
        st = self.sim.stepper.step(state.sim, actions, self.sim.params)
        return PickState(sim=st, hand_restart=hand_restart), (gripped, box_z)

    def control(self, state: PickState):
        """The grasp FSM and the task-space controller: (actions,
        hand_restart, gripped, box z) for this step."""
        st = state.sim
        box_pos = st.root_pos[:, self.box_slot]
        box_rot = st.root_quat[:, self.box_slot]
        hand_pos = st.body_pos[:, self.hand_body]
        hand_rot = st.body_quat[:, self.hand_body]
        sl = slice(self.dof0, self.dof0 + 9)
        dof_pos = st.dof_pos[:, sl]
        dof_vel = st.dof_vel[:, sl]

        to_box = box_pos - hand_pos
        box_dist = torch.linalg.vector_norm(to_box, dim=-1)
        box_dot = (to_box / box_dist.clamp_min(1e-9)[:, None]) @ self._down

        gripper_sep = dof_pos[:, 7] + dof_pos[:, 8]
        gripped = (gripper_sep < 0.045) & (box_dist < self.grasp_offset + 0.5 * BOX_SIZE)

        yaw_q = _box_grasp_yaw(box_rot, self._x_axis)
        box_yaw_dir = quat_rotate(yaw_q, self._x_axis)
        hand_yaw_dir = quat_rotate(hand_rot, self._x_axis)
        yaw_dot = (box_yaw_dir * hand_yaw_dir).sum(-1)

        to_init = self.init_hand_pos - hand_pos
        init_dist = torch.linalg.vector_norm(to_init, dim=-1)
        hand_restart = state.hand_restart & (init_dist > 0.02)
        return_to_start = hand_restart | gripped

        above_box = (box_dot >= 0.99) & (yaw_dot >= 0.95) & (box_dist < self.grasp_offset * 3)
        grasp_z = torch.where(
            above_box,
            box_pos[:, 2] + self.grasp_offset,
            box_pos[:, 2] + self.grasp_offset * 2.5,
        )
        grasp_pos = torch.cat([box_pos[:, :2], grasp_z[:, None]], -1)

        goal_pos = torch.where(return_to_start[:, None], self.init_hand_pos, grasp_pos)
        goal_rot = torch.where(
            return_to_start[:, None],
            self.init_hand_quat,
            quat_mul(self._down_q.expand(box_rot.shape), quat_conjugate(yaw_q)),
        )

        pos_err = goal_pos - hand_pos
        orn_err = orientation_error(goal_rot, hand_rot)
        dpose = torch.cat([pos_err, orn_err], dim=-1)

        j_eef = self._hand_jac(st)[:, :, :7]
        actions = self.sim.actions
        if self.controller == "ik":
            arm_target = dof_pos[:, :7] + control_ik(j_eef, dpose, damping=self.ik_damping)
            effort = torch.zeros_like(dof_pos)
        else:
            mm7 = self._mm(st, self.sim.params)[:, :7, :7]
            jt = j_eef.transpose(-1, -2)
            m_eef_inv = j_eef @ spd_solve(mm7, jt)
            u = (
                jt @ spd_solve(m_eef_inv, self.osc_kp * dpose)[..., None]
                - 2.0 * math.sqrt(self.osc_kp) * (mm7 @ dof_vel[:, :7, None])
            )[..., 0]
            arm_target = dof_pos[:, :7]
            effort = torch.cat([u, torch.zeros_like(u[:, :2])], dim=-1)

        close_gripper = (box_dist < self.grasp_offset + 0.02) | gripped
        hand_restart = hand_restart | (box_pos[:, 2] > 0.6)
        close_gripper = close_gripper & ~hand_restart
        # target 0 like the reference (:404): the fingers stop ON the cube
        # because finger-link contact is two-way (joint-space impulses) and
        # the drive torque is force-limited — PhysX-style squeeze
        grip_target = torch.where(close_gripper[:, None], 0.0, 0.04).expand(-1, 2)
        pos_target = torch.cat([arm_target, grip_target], -1)

        actions = actions._replace(
            dof_pos_target=actions.dof_pos_target.index_copy(1, self._dof, pos_target),
            dof_effort=actions.dof_effort.index_copy(1, self._dof, effort),
        )
        return actions, hand_restart, gripped, box_pos[:, 2]

    # ------------------------------------------------------------------
    def rollout(self, num_steps: int, state: Optional[PickState] = None):
        """num_steps steps from `state` (init_state by default): (the end
        state, (gripped, box z)), the per-step outputs stacked to
        (num_steps, N) as the JAX package's lax.scan stacks them."""
        state = self.init_state if state is None else state
        gripped, box_z = [], []
        for _ in range(num_steps):
            state, (g, z) = self.step_fn(state)
            gripped.append(g)
            box_z.append(z)
        return state, (torch.stack(gripped), torch.stack(box_z))

    def rollout_fn(self, num_steps: int):
        """rollout as a callable of the start state."""
        return lambda state: self.rollout(num_steps, state)

    def box_height(self, state: PickState):
        return state.sim.root_pos[:, self.box_slot, 2]

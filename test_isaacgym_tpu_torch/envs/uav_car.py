"""Batched UAV-car pursuit vecenv with visual servo.

Port of test_isaacgym_tpu/envs/uav_car.py, the reference's north-star
workload family (its test06 vecenv root-state control, test07/test08 camera
projection, test10 batched servo).

Per env: a kinematic car loitering around a target under CCLVF guidance, a
UAV pursuing the car under CCLVF, and a gimballed camera on the UAV that
visual-servos to keep the car centered in the image. One control + write +
physics step is a run of eager PyTorch ops on `device` with no host sync;
`rollout` loops it.

Assets: the reference's UAV/car URDFs when `asset_root` holds them (their
<mesh> geometry loads as convex hulls), primitive boxes otherwise, as in
the JAX package when the reference's assets are absent. The dynamics are kinematic
root writes either way.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..assets import load_urdf
from ..assets.primitives import create_box
from ..control.guidance import cclvf, heading_quat
from ..control.servo import align_axis_to, camera_matrix, recenter_rotation
from ..core.config import CameraProperties, SimParams
from ..core.scene import SceneBuilder
from ..core.sim import Simulator
from ..core.state import SimState, from_numpy
from ..math.quat import matrix_to_quat
from ..render.camera import world_to_pixel

UAV_URDF = "urdf/uav/urdf/rq-1-predator-mae-uav.urdf"
CAR_URDF = "urdf/uav/urdf/tpz-fuchs-apc.urdf"


class ServoState(NamedTuple):
    """Carry of the vecenv rollout: sim state + per-env camera rotation."""

    sim: SimState
    cam_rot: torch.Tensor  # (N, 3, 3) world<-camera

    @staticmethod
    def from_numpy(sim: dict, cam_rot, device) -> "ServoState":
        """The JAX env's state carried across: `sim` a dict of numpy arrays
        keyed by SimState field (core/state.py's from_numpy), `cam_rot` an
        (N, 3, 3) array; copies on `device`."""
        rot = np.array(cam_rot, dtype=np.float32, order="C", copy=True)
        return ServoState(sim=from_numpy(sim, SimState, device),
                          cam_rot=torch.from_numpy(rot).to(device))


@dataclasses.dataclass
class UavCarEnv:
    num_envs: int = 16
    car_speed: float = 10.0
    car_radius: float = 10.0
    uav_speed: float = 20.0
    uav_radius: float = 20.0
    uav_altitude: float = 20.0
    cam_width: int = 160
    cam_height: int = 90
    cam_hfov: float = 90.0
    target: tuple = (1.0, 1.0, 0.0)  # loiter target (test06:422)
    asset_root: Optional[str] = None  # a directory holding UAV_URDF / CAR_URDF
    device: str = "cuda"

    def __post_init__(self):
        dev = torch.device(self.device)
        sp = SimParams(dt=1 / 60, substeps=1, gravity=(0.0, 0.0, -9.8))
        uav = self._load(UAV_URDF, (0.4, 0.4, 0.1))
        car = self._load(CAR_URDF, (0.6, 0.3, 0.15))
        uav.disable_gravity = True
        car.disable_gravity = True
        b = SceneBuilder(sp)
        n_row = max(int(np.sqrt(self.num_envs)), 1)
        rng = np.random.RandomState(17)
        for i in range(self.num_envs):
            b.create_env((-25, -25, 0), (25, 25, 30), n_row)
            # spread initial positions so envs decorrelate
            b.create_actor(
                i, uav,
                pos=(rng.uniform(-5, 5), rng.uniform(-5, 5), self.uav_altitude),
                name="uav", group=i, filter=1,
            )
            b.create_actor(
                i, car,
                pos=(rng.uniform(-15, 15), rng.uniform(-15, 15), 0.2),
                name="car", group=i, filter=1,
            )
        self.sim = Simulator(*b.finalize(dev), device=dev)
        self.uav_slot = self.sim.scene.find_actor("uav").slot
        self.car_slot = self.sim.scene.find_actor("car").slot
        self._slots = torch.tensor([self.uav_slot, self.car_slot], device=dev)
        self.K = camera_matrix(self.cam_width, self.cam_height, self.cam_hfov, dev)
        self.target_w = self.sim.env_origins + torch.tensor(
            self.target, dtype=torch.float32, device=dev)
        self._altitude = torch.tensor([0.0, 0.0, self.uav_altitude], device=dev)
        self._center = torch.tensor(
            [self.cam_width / 2, self.cam_height / 2], dtype=torch.float32, device=dev)
        # camera starts looking straight down from the UAV
        down = np.array(
            [[0, 0, -1.0], [0, 1.0, 0], [1.0, 0, 0]], np.float32
        ).T  # columns: fwd=-z_w, left=+y_w, up=+x_w
        self.init_state = ServoState(
            sim=self.sim.state,
            cam_rot=torch.as_tensor(down, device=dev).repeat(self.num_envs, 1, 1),
        )

    def _load(self, rel, fallback_box):
        if self.asset_root is not None and os.path.exists(os.path.join(self.asset_root, rel)):
            a = load_urdf(self.asset_root, rel)
            if a.num_dofs == 0 and a.num_bodies == 1:
                return a
        return create_box(*fallback_box, density=200.0)

    # ------------------------------------------------------------------
    def step_fn(self, state: ServoState, _=None):
        """One control + physics step: (new state, (pixel (N, 2), servo
        rpy (N, 3)))."""
        st = state.sim
        uav_pos = st.root_pos[:, self.uav_slot]
        car_pos = st.root_pos[:, self.car_slot]

        # -- guidance (the reference's test06:420-441 semantics, batched) --
        car_vel = cclvf(car_pos, self.target_w, self.car_speed, self.car_radius)
        car_vel = torch.cat([car_vel[:, :2], torch.zeros_like(car_vel[:, 2:])], -1)
        uav_goal = car_pos + self._altitude
        uav_vel = cclvf(uav_pos, uav_goal, self.uav_speed, self.uav_radius)
        car_quat = heading_quat(car_vel)
        uav_quat = heading_quat(uav_vel)

        # root-state write (replaces set_actor_root_state_tensor)
        rq = st.root_quat.index_copy(1, self._slots, torch.stack([uav_quat, car_quat], 1))
        rl = st.root_linvel.index_copy(1, self._slots, torch.stack([uav_vel, car_vel], 1))
        st = st._replace(root_quat=rq, root_linvel=rl)

        # physics step (kinematic integration of the written velocities)
        st = self.sim.stepper.step(st, self.sim.actions, self.sim.params)

        # -- visual servo (the reference's test10:427-456 semantics) --
        cam_pos = st.root_pos[:, self.uav_slot]  # camera at UAV origin
        car_now = st.root_pos[:, self.car_slot]
        pixel, depth = world_to_pixel(cam_pos, matrix_to_quat(state.cam_rot), car_now,
                                      self._props())
        pixel_move = pixel - self._center
        # measurement-driven servo while the car is in front of the image
        # plane; direct-bearing acquisition otherwise (pixel coordinates are
        # undefined for points behind the camera)
        new_rot, rpy = recenter_rotation(state.cam_rot, pixel_move, self.K)
        rel = car_now - cam_pos
        bearing = rel / torch.linalg.vector_norm(rel, dim=-1, keepdim=True).clamp_min(1e-9)
        acq_rot = align_axis_to(state.cam_rot, bearing)
        behind = (depth <= 1e-6)[:, None, None]
        new_rot = torch.where(behind, acq_rot, new_rot)
        return ServoState(sim=st, cam_rot=new_rot), (pixel, rpy)

    def _props(self):
        return CameraProperties(
            width=self.cam_width, height=self.cam_height, horizontal_fov=self.cam_hfov,
        )

    # ------------------------------------------------------------------
    def rollout(self, num_steps: int, state: Optional[ServoState] = None):
        """num_steps steps from `state` (default: the initial state): the
        final state and the per-step (pixel (T, N, 2), servo rpy (T, N, 3)),
        stacked as lax.scan stacks them."""
        state = state if state is not None else self.init_state
        pixels, rpys = [], []
        for _ in range(num_steps):
            state, (pixel, rpy) = self.step_fn(state)
            pixels.append(pixel)
            rpys.append(rpy)
        return state, (torch.stack(pixels), torch.stack(rpys))

    def car_pixel(self, state: ServoState):
        """Where the car lands in the (already servoed) camera image."""
        cam_pos = state.sim.root_pos[:, self.uav_slot]
        pix, _ = world_to_pixel(cam_pos, matrix_to_quat(state.cam_rot),
                                state.sim.root_pos[:, self.car_slot], self._props())
        return pix

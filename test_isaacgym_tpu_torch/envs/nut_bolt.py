"""Nut-on-bolt threading via SDF collision.

Port of test_isaacgym_tpu/envs/nut_bolt.py, the physics core of the
reference's examples/franka_nut_bolt_ik_osc.py: an M4 nut at 5x scale
screwed down a bolt by PhysX SDF contact (32 position iterations, the
`<sdf resolution>` hints of assets/urdf/nut_bolt/*.urdf). The bolt's mesh
and SDF are generated from the thread parameters measured off the nut
(assets/sdf.py::BoltSpec), its closed form evaluated inline by the
narrowphase.

The env spins the nut about the bolt axis and the SDF thread contact turns
rotation into descent at pitch/(2*pi) per radian. Control and physics run
as eager PyTorch ops on `device`.

`asset_root` defaults to the nut stand-in committed in this package
(assets/data/nut_standin, written by tools/make_nut_standin.py): the
reference's nut OBJ is not in the repository.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..assets import create_mesh_asset, load_urdf
from ..assets.sdf import BoltSpec, bolt_mesh, bolt_sdf_fn, sdf_from_fn
from ..core.config import PlaneParams, SimParams
from ..core.scene import SceneBuilder
from ..core.sim import Simulator
from ..core.state import SimState

NUT_STANDIN_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "data", "nut_standin",
)
NUT_URDF = "urdf/nut_bolt/nut_m4_tight_SI_5x.urdf"


@dataclasses.dataclass
class NutBoltEnv:
    num_envs: int = 4
    scale: float = 5.0  # the reference example uses the *_5x assets
    # driven nut spin about z (rad/s). Right-hand thread: u = z - p*theta/2pi,
    # so NEGATIVE spin (clockwise from above) screws the nut DOWN — the same
    # sign the reference FSM drives (its rotation phase).
    spin: float = -2.0 * np.pi
    env_spacing: float = 0.2  # 0 co-locates envs (bitwise-determinism tests)
    asset_root: str = NUT_STANDIN_ROOT
    device: str = "cuda"

    def __post_init__(self):
        dev = torch.device(self.device)
        s = self.scale
        spec = BoltSpec(scale=s)
        l, hh, hr = spec.length * s, spec.head_h * s, spec.head_r * s
        half_z = (l + hh) * 0.5
        bolt_grid = sdf_from_fn(
            bolt_sdf_fn(spec), (-hr, -hr, -half_z), (hr, hr, half_z)
        )
        bv, bf = bolt_mesh(spec)
        bolt = create_mesh_asset(
            "bolt", bv, bf, density=7800.0, sdf=bolt_grid, fix_base_link=True
        )
        nut = load_urdf(self.asset_root, NUT_URDF, density=7800.0)

        sp = SimParams(dt=1 / 120, substeps=2, gravity=(0.0, 0.0, -9.8))
        sp.physx.num_position_iterations = 32  # the reference's :231
        sp.physx.contact_offset = 0.001 * s / 5.0
        sp.physx.rest_offset = 0.0
        sp.physx.contact_slop = 1e-4 * s / 5.0  # thread tolerance << 1.5mm
        # kinematic spin + 256 FPS probes capture the thread manifold from
        # the nut side alone, against the bolt's closed form
        sp.physx.sdf_bidirectional = False

        pitch = spec.pitch * s
        self.pitch = pitch
        # Start height: threads must MATE (the nut's internal thread phase
        # lines up with the bolt's external one) and the nut must clear the
        # bolt head below: scan one pitch of candidate heights around
        # mid-shank and keep the one with maximum probe clearance (the
        # bolt's closed form on numpy, build time only).
        probes = next(
            g.sdf_samples
            for l in nut.links
            for g in l.geoms
            if getattr(g, "sdf_samples", None) is not None
        )
        fn = bolt_sdf_fn(spec)
        nut_half = float(probes[:, 2].max())
        target = hh + nut_half + 2.5 * pitch  # clears the head by ~2 pitches
        zs = np.arange(target - pitch / 2, target + pitch / 2, pitch / 64)
        clear = np.array(
            [fn(probes + np.array([0.0, 0.0, z - half_z], np.float32)).min()
             for z in zs]
        )
        nut_z = float(zs[int(np.argmax(clear))])
        if clear.max() < 0:
            raise RuntimeError(
                f"nut/bolt threads never mate (best clearance {clear.max():.2e})"
            )

        b = SceneBuilder(sp)
        b.add_ground(PlaneParams())
        d = self.env_spacing
        for e in range(self.num_envs):
            b.create_env((-d, -d, 0), (d, d, 0.4), self.num_envs)
            b.create_actor(e, bolt, pos=(0, 0, half_z), name="bolt", group=e, filter=0)
            b.create_actor(e, nut, pos=(0, 0, nut_z), name="nut", group=e, filter=0)
        self.sim = Simulator(*b.finalize(dev), device=dev)
        meta = self.sim.scene.find_actor("nut")
        self.nut_slot = meta.slot

        # The nut is rotation-servoed (an ideal wrench): effectively infinite
        # rotational inertia, so contact impulses move it only
        # translationally and the thread contact converts the forced
        # rotation into descent.
        p = self.sim.params
        inertia = p.body_inertia.clone()
        inertia[:, meta.body_start] = torch.eye(3, device=dev) * 1e3
        self.sim.params = p._replace(body_inertia=inertia)
        self._slot = torch.tensor([self.nut_slot], device=dev)
        self._spin = torch.tensor([[[0.0, 0.0, self.spin]]], device=dev)
        self.sim.state = self._spun(self.sim.state)
        self.sim.initial_state = self.sim.state

    def _spun(self, state: SimState) -> SimState:
        """state with the nut's angular velocity set to the drive's spin."""
        w = self._spin.expand(state.root_angvel.shape[0], 1, 3)
        return state._replace(root_angvel=state.root_angvel.index_copy(1, self._slot, w))

    def rollout_fn(self, num_steps: int):
        """A callable (state) -> state after num_steps steps: each re-imposes
        the nut's spin about +z (the kinematic drive of the reference FSM's
        rotation phase) and lets SDF thread contact convert it into
        descent."""
        stp, actions, params = self.sim.stepper, self.sim.actions, self.sim.params

        def run(state: SimState) -> SimState:
            for _ in range(num_steps):
                state = stp.step(self._spun(state), actions, params)
            return state

        return run

    def rollout(self, num_steps: int, state: Optional[SimState] = None) -> SimState:
        """rollout_fn's steps from `state` (the initial state by default)."""
        return self.rollout_fn(num_steps)(self.sim.state if state is None else state)

    def nut_height(self, state: SimState):
        return state.root_pos[:, self.nut_slot, 2]

"""Full Franka nut-bolt screwing task: ARM-driven pick -> place -> screw.

Port of test_isaacgym_tpu/envs/franka_nut_bolt.py, the counterpart of the
reference's examples/franka_nut_bolt_ik_osc.py, its hardest contact-rich
behavior: the 11-state ScrewFSM (:41-203) drives the Franka with
damped-least-squares IK (:33-37, damping 0.15 :244) to pick the free nut
off the table, place it over the fixed bolt, and SCREW it down by twisting
the wrist +-60 deg at 30 deg/s with re-grips. The nut descends because
gripper FRICTION carries the forced wrist rotation into the SDF thread
contact — nothing is kinematically spun (envs/nut_bolt.py keeps the
servoed variant).

As in the JAX package: the FSM is batched (a state int per env, target
selection by torch.where); the bolt's mesh and SDF are generated from the
thread parameters (assets/sdf.py::BoltSpec); shape props follow the
reference's :387-414. Control and physics run as eager PyTorch ops on
`device`, with no host sync in a step. With `sdf_bidirectional` on, the
nut-bolt pair runs both SDF families: the nut's probes against the bolt's
closed form, and the bolt's probes against the nut's voxel grid.

The assets default to the stand-ins committed in this package: the Panda
with collision boxes on the hand and fingers (`franka_panda_boxes.urdf`
under envs/franka.py::STANDIN_ROOT) and the code-built nut
(envs/nut_bolt.py::NUT_STANDIN_ROOT). The boxes have no vertices, so the
finger pads get no surface probes, as in the JAX package: finger-vs-nut
contact is the box-vs-hull kinds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..assets import create_mesh_asset, load_urdf
from ..assets.primitives import create_box
from ..assets.sdf import BoltSpec, bolt_mesh, bolt_sdf_fn, sample_hull_surface, sdf_from_fn
from ..control.osc import control_ik, orientation_error
from ..core.config import SimParams, PlaneParams
from ..core.scene import SceneBuilder
from ..core.sim import Simulator
from ..core.state import SimState
from ..math.quat import quat_mul
from .franka import STANDIN_ROOT
from .nut_bolt import NUT_STANDIN_ROOT, NUT_URDF

FRANKA_URDF = "urdf/franka_description/robots/franka_panda_boxes.urdf"
TABLE_DIMS = (0.6, 1.0, 0.4)

# FSM states (the reference's :78-180)
(S_ABOVE_NUT, S_PREP_GRIP, S_GRIP, S_LIFT, S_ABOVE_BOLT, S_ON_BOLT,
 S_LOOSEN, S_SCREW, S_UNGRIP, S_ROTBACK, S_REGRIP) = range(11)
NUM_STATES = 11


def _z_quat(angle):
    """quat_from_angle_axis about +z, batched angle."""
    half = angle / 2
    z = torch.zeros_like(half)
    return torch.stack([z, z, torch.sin(half), torch.cos(half)], dim=-1)


def _select(fsm, choices):
    """Each env's entry of `choices` (one (N, ...) tensor a state) at its
    FSM state, by torch.where over the states."""
    out = choices[-1]
    for s in range(len(choices) - 2, -1, -1):
        on = fsm == s
        out = torch.where(on.reshape(on.shape + (1,) * (out.dim() - 1)), choices[s], out)
    return out


class ScrewState(NamedTuple):
    sim: SimState
    fsm: torch.Tensor  # (N,) int32 state
    screw_angle: torch.Tensor  # (N,) wrist screw phase (rad)


@dataclasses.dataclass
class FrankaNutBoltEnv:
    num_envs: int = 4
    seed: int = 42
    ik_damping: float = 0.15  # the reference's :244
    screw_speed: float = np.deg2rad(30.0)  # :437
    screw_limit: float = np.deg2rad(60.0)  # :437
    nut_height: float = 0.016  # :437
    bolt_height: float = 0.1  # :437 (FSM margin constant, not geometry)
    # start with the nut already threaded at the bolt top and the FSM in
    # LOOSEN: exercises the screw cycle without the table pick.
    start_on_bolt: bool = False
    # screw-phase gripper separation: the nut measures 0.035 across flats,
    # so 0.0345 squeezes the flats ~0.25 mm each side (the reference's
    # 0.037 leaves the pads hovering clear of this nut)
    screw_sep: float = 0.0345
    asset_root: str = STANDIN_ROOT  # the Panda's
    nut_root: str = NUT_STANDIN_ROOT
    device: str = "cuda"

    def __post_init__(self):
        dev = torch.device(self.device)
        sp = SimParams(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, -9.8))
        sp.physx.num_position_iterations = 32  # :231
        sp.physx.num_velocity_iterations = 1
        sp.physx.rest_offset = 0.0
        sp.physx.contact_offset = 0.005  # :234
        sp.physx.contact_slop = 5e-4

        # tip_chamfer: conical lead-in so the blindly placed nut
        # self-centers and the first thread catches (assets/sdf.BoltSpec)
        spec = BoltSpec(scale=5.0, tip_chamfer=1.5)
        s = spec.scale
        l, hh, hr = spec.length * s, spec.head_h * s, spec.head_r * s
        self.bolt_half_z = (l + hh) * 0.5
        bolt_grid = sdf_from_fn(
            bolt_sdf_fn(spec), (-hr, -hr, -self.bolt_half_z),
            (hr, hr, self.bolt_half_z),
        )
        bv, bf = bolt_mesh(spec)
        bolt = create_mesh_asset(
            "bolt", bv, bf, density=800.0, sdf=bolt_grid, fix_base_link=True
        )
        nut = load_urdf(self.nut_root, NUT_URDF, density=800.0)
        for link in nut.links:
            for g in link.geoms:
                g.friction = 0.2  # :407
                g.restitution = 0.0
        for link in bolt.links:
            for g in link.geoms:
                # the reference sets bolt mu = 0 (:389) and relies on PhysX's
                # SDF contact torsional resistance to keep the nut from
                # gravity-spinning down the thread; the point-probe Coulomb
                # cone has no torsional term, so the bolt gets mu 0.6
                # (combined 0.4, friction angle 22 deg vs the 3.6 deg lead)
                g.friction = 0.6
                g.restitution = 0.0
        table = create_box(*TABLE_DIMS, fix_base_link=True)
        franka = load_urdf(self.asset_root, FRANKA_URDF, fix_base_link=True, armature=0.01)
        franka.disable_gravity = True
        # finger pads: surface-sampled probes where the pad has vertices
        # (a flat squeeze instead of corner bites), and rubber friction
        for link in franka.links:
            if "finger" in link.name:
                for g in link.geoms:
                    if g.vertices is not None:
                        g.sdf_samples = sample_hull_surface(g.vertices - g.mesh_center(), 96)
                    g.friction = 4.0

        z_mate = None
        if self.start_on_bolt:
            # thread-mating root height near the bolt TOP (the build-time
            # clearance scan of envs/nut_bolt.py, in the nut ROOT frame so
            # the shape's AABB-center offset is exact)
            g0 = next(
                g for l in nut.links for g in l.geoms
                if getattr(g, "sdf_samples", None) is not None
            )
            probes_root = np.asarray(g0.sdf_samples) + np.asarray(g0.center(), np.float32)
            fn = bolt_sdf_fn(spec)
            pitch = spec.pitch * s
            # below the tip chamfer zone, so the primed nut's whole height
            # engages full-depth thread
            top = hh + l - float(probes_root[:, 2].max()) - (spec.tip_chamfer + 1.0) * pitch
            zs = np.arange(top - pitch / 2, top + pitch / 2, pitch / 64)
            clear = np.array([
                fn(probes_root + np.array([0, 0, z - self.bolt_half_z], np.float32)).min()
                for z in zs
            ])
            z_mate = float(zs[int(np.argmax(clear))])
            if clear.max() < 0:
                raise RuntimeError("start_on_bolt: threads never mate")

        rng = np.random.RandomState(self.seed)
        b = SceneBuilder(sp)
        b.add_ground(PlaneParams())
        n_row = max(int(np.sqrt(self.num_envs)), 1)
        for i in range(self.num_envs):
            b.create_env((-1, -1, 0), (1, 1, 1), n_row)
            b.create_actor(
                i, table, pos=(0.5, 0.0, 0.5 * TABLE_DIMS[2]), name="table",
                group=i, filter=0,
            )
            # bolt base ON the table (:383-386), standing upright
            bx = 0.5 + rng.uniform(-0.1, 0.1)
            by = rng.uniform(-0.3, 0.0)
            b.create_actor(
                i, bolt, pos=(bx, by, TABLE_DIMS[2] + self.bolt_half_z),
                name="bolt", group=i, filter=0,
            )
            if self.start_on_bolt:
                nut_pos = (bx, by, TABLE_DIMS[2] + z_mate)
            else:
                # nut flat on the table, offset from the bolt (:402-405)
                nut_pos = (
                    bx + rng.uniform(-0.04, 0.04),
                    by + 0.2 + rng.uniform(-0.04, 0.04),
                    TABLE_DIMS[2] + 0.02,
                )
            b.create_actor(i, nut, pos=nut_pos, name="nut", group=i, filter=0)
            b.create_actor(i, franka, pos=(0, 0, 0), name="franka", group=i, filter=2)
        self.sim = Simulator(*b.finalize(dev), device=dev)
        scene = self.sim.scene

        meta = scene.find_actor("franka")
        self.nut_slot = scene.find_actor("nut").slot
        self.bolt_slot = scene.find_actor("bolt").slot
        self.hand_body = meta.body_start + franka.rigid_body_dict()["panda_hand"]
        self.dof0 = meta.dof_start
        self._hand_jac = self.sim.body_jacobian_fn("franka", "panda_hand")

        # stiff position drives (:322-329)
        sl = slice(self.dof0, self.dof0 + 9)
        stiff = np.full(9, 400.0, np.float32)
        stiff[7:] = 800.0
        damp = np.full(9, 40.0, np.float32)
        maxv = np.full(9, 1e3, np.float32)
        maxv[7:] = 0.05  # quasistatic gripper close: a snapping squeeze on
        # a 16 mm nut ejects it before the contact solve can brace it
        p = self.sim.params

        def put(full, part):
            full = full.clone()
            full[:, sl] = torch.as_tensor(part, device=dev, dtype=full.dtype)
            return full

        self.sim.params = p._replace(
            dof_stiffness=put(p.dof_stiffness, stiff),
            dof_damping=put(p.dof_damping, damp),
            dof_drive_mode=put(p.dof_drive_mode, np.ones(9, np.int32)),
            dof_max_velocity=put(p.dof_max_velocity, maxv),
        )
        # default pose: 0.3 * (lo + hi) (:334-336), grippers open
        lo = self.sim.params.dof_lower[0, sl].cpu().numpy()
        hi = self.sim.params.dof_upper[0, sl].cpu().numpy()
        q0 = 0.3 * (lo + hi)
        q0[7:] = hi[7:]
        q0v = np.tile(q0.astype(np.float32), (self.num_envs, 1))
        st = self.sim.state
        st = st._replace(dof_pos=put(st.dof_pos, q0v))
        self.sim.state = self.sim.stepper.refresh_body_state(st, self.sim.params)
        self.sim.initial_state = self.sim.state
        a = self.sim.actions
        self.sim.actions = a._replace(dof_pos_target=put(a.dof_pos_target, q0v))

        # FSM offsets (:56-60), adapted to this asset's frames: the nut's
        # solid sits z in [z_lo, z_hi] about its URDF origin, and the
        # generated bolt's origin is the mesh CENTER
        nut_verts = next(
            g.vertices for l in nut.links for g in l.geoms if g.vertices is not None
        )
        z_lo = float(nut_verts[:, 2].min())
        z_hi = float(nut_verts[:, 2].max())
        # hand height over the nut ORIGIN that puts the finger pads at the
        # solid's midline (pads sit ~0.105 below the hand frame)
        grip_z = 0.105 + 0.5 * (z_lo + z_hi)

        def vec(*v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        self.grip_off = vec(0.0, 0.0, grip_z)
        self.above_off = vec(0.0, 0.0, 0.08 + self.bolt_height)
        self.lift_off = vec(0.0, 0.0, 0.15 + self.bolt_height)
        # release pose: nut solid BOTTOM ~2 mm above the bolt top, so the
        # loosened nut drops under one thread pitch and the SDF contact
        # catches the first turn instead of free-falling down the shank
        on_bolt_z = self.bolt_half_z + grip_z - z_lo + 0.002
        self.on_bolt_off = vec(0.0, 0.0, on_bolt_z)
        self.above_bolt_off = vec(0.0, 0.0, on_bolt_z + 0.08)
        self._down_q = vec(1.0, 0.0, 0.0, 0.0)  # hand straight down (:61)
        self.nut_grab_q = quat_mul(_z_quat(vec(np.pi / 6.0)[0]), self._down_q)  # :62-65
        self._press = vec(0.0, 0.0, 3e-3)
        self._xy = vec(1.0, 1.0, 0.0)
        self._dof = torch.arange(self.dof0, self.dof0 + 9, device=dev)

        fsm0 = S_LOOSEN if self.start_on_bolt else S_ABOVE_NUT
        self.init_state = ScrewState(
            sim=self.sim.state,
            fsm=torch.full((self.num_envs,), fsm0, dtype=torch.int32, device=dev),
            screw_angle=torch.zeros(self.num_envs, dtype=torch.float32, device=dev),
        )

    # ------------------------------------------------------------------
    def control(self, state: ScrewState):
        """The FSM and the IK controller: (actions, next fsm, next screw
        angle, task-space error (N,)) for this step (the reference's
        :78-180, :497)."""
        st = state.sim
        N = self.num_envs
        fsm = state.fsm
        ang = state.screw_angle
        dt = self.sim.scene.sim_params.dt

        nut_p = st.root_pos[:, self.nut_slot]
        nut_q = st.root_quat[:, self.nut_slot]
        bolt_p = st.root_pos[:, self.bolt_slot]
        hand_p = st.body_pos[:, self.hand_body]
        hand_q = st.body_quat[:, self.hand_body]
        sl = slice(self.dof0, self.dof0 + 9)
        dof_pos = st.dof_pos[:, sl]
        grip_sep = dof_pos[:, 7] + dof_pos[:, 8]
        grip_vel = st.dof_vel[:, self.dof0 + 7] + st.dof_vel[:, self.dof0 + 8]

        def onehot(s):
            return fsm == s

        dq = self._down_q.expand(N, 4)
        # per-state targets
        nut_bolt_z = torch.cat([bolt_p[:, :2], nut_p[:, 2:]], -1)  # [bolt_x, bolt_y, nut_z]
        lift_p = torch.cat([nut_p[:, :2], bolt_p[:, 2:] + 0.004], -1)
        screw_q = quat_mul(_z_quat(ang), dq)
        # light axial press while turning, ~3 mm below the tracked height:
        # without it the finger friction holds the nut at the bolt top and
        # the thread never catches
        press = self._press
        # carry correction, in the transfer states only: steer the NUT, not
        # the eccentrically gripped hand, onto the bolt axis
        carry = (hand_p - nut_p) * self._xy
        grip_t = nut_bolt_z + self.grip_off
        tgt_pos = _select(fsm, [
            nut_p + self.above_off,
            nut_p + self.grip_off,
            nut_p + self.grip_off,
            lift_p + self.lift_off,
            bolt_p + self.above_bolt_off + carry,
            bolt_p + self.on_bolt_off + carry,
            bolt_p + self.on_bolt_off,
            # screw family: xy pinned to the bolt axis, z tracking the nut
            grip_t - press,
            grip_t,
            grip_t,
            grip_t,
        ])
        # grab orientation: pads on the nut flats, the nut's yaw wrapped
        # into [-30, 30) deg by the hex symmetry so the wrist twist target
        # stays inside the joint limit
        nut_yaw = torch.atan2(
            2 * (nut_q[:, 3] * nut_q[:, 2] + nut_q[:, 0] * nut_q[:, 1]),
            1 - 2 * (nut_q[:, 1] ** 2 + nut_q[:, 2] ** 2),
        )
        wrapped = torch.remainder(nut_yaw + math.pi / 6, math.pi / 3) - math.pi / 6
        grab_q = quat_mul(_z_quat(wrapped), self.nut_grab_q.expand(N, 4))
        tgt_q = _select(fsm, [dq, grab_q, grab_q, dq, dq, dq, dq,
                              screw_q, screw_q, screw_q, screw_q])
        ss = self.screw_sep
        # S_LOOSEN opens WIDE: the released nut needs lateral slack to
        # self-center on the bolt's tip chamfer
        tgt_sep = _select(fsm, [torch.full((N,), v, device=fsm.device) for v in
                                (0.08, 0.08, 0.0, 0.0, 0.0, 0.0, 0.05, ss, 0.06, 0.06, ss)])

        pos_err = tgt_pos - hand_p
        orn_err = orientation_error(tgt_q, hand_q)
        dpose = torch.cat([pos_err, orn_err], dim=-1)
        err = torch.linalg.vector_norm(dpose, dim=-1)

        # transitions (the reference's thresholds); nut-carrying states use
        # a looser bar, the steady-state error with the nut's weight
        small = err < 2e-3
        small_carry = err < 8e-3
        # a real grasp: fingers stopped ON the nut, not still closing and
        # not closed through air
        gripped = (grip_sep < 0.035) & (grip_sep > 0.015) & (grip_vel.abs() < 5e-3)
        un37 = grip_sep > self.screw_sep * 0.95
        un60 = grip_sep > 0.06 * 0.98
        re37 = grip_sep < self.screw_sep * 1.06
        nxt = fsm
        nxt = torch.where(onehot(S_ABOVE_NUT) & small, S_PREP_GRIP, nxt)
        nxt = torch.where(onehot(S_PREP_GRIP) & small, S_GRIP, nxt)
        nxt = torch.where(onehot(S_GRIP) & (err < 1e-2) & gripped, S_LIFT, nxt)
        # missed grasp (fingers closed through air): reopen and retry
        nxt = torch.where(onehot(S_GRIP) & (grip_sep < 0.012), S_ABOVE_NUT, nxt)
        nxt = torch.where(onehot(S_LIFT) & small_carry, S_ABOVE_BOLT, nxt)
        nxt = torch.where(onehot(S_ABOVE_BOLT) & small_carry, S_ON_BOLT, nxt)
        # release over the bolt only when the nut's hole is over the shank
        nut_ax = torch.linalg.vector_norm((nut_p - bolt_p)[:, :2], dim=-1)
        nxt = torch.where(onehot(S_ON_BOLT) & small_carry & (nut_ax < 3e-3), S_LOOSEN, nxt)
        loosen_done = onehot(S_LOOSEN) & small & un37
        nxt = torch.where(loosen_done, S_SCREW, nxt)
        screw_done = onehot(S_SCREW) & (ang < -self.screw_limit)
        nxt = torch.where(screw_done, S_UNGRIP, nxt)
        nxt = torch.where(onehot(S_UNGRIP) & un60, S_ROTBACK, nxt)
        back_done = onehot(S_ROTBACK) & (ang > 0.99 * self.screw_limit)
        nxt = torch.where(back_done, S_REGRIP, nxt)
        regrip_done = onehot(S_REGRIP) & small & re37
        nxt = torch.where(regrip_done, S_SCREW, nxt)

        # screw phase evolution (:141, :163, :55 reset, :178 re-entry)
        ang = torch.where(onehot(S_SCREW), ang - dt * self.screw_speed, ang)
        ang = torch.where(onehot(S_ROTBACK), ang + dt * 2.0 * self.screw_speed, ang)
        ang = torch.where(loosen_done, 0.0, ang)
        ang = torch.where(regrip_done, self.screw_limit, ang)

        # damped-least-squares IK (:33-37, :497): position rows weighted 3x
        # so a rotating orientation target does not swamp the centimeter
        # position error, and the translation command rate-limited to 2 cm
        # a step so the carry stays quasi-static
        j_eef = self._hand_jac(st)[:, :, :7]
        pn = torch.linalg.vector_norm(pos_err, dim=-1, keepdim=True)
        pos_cmd = pos_err * torch.clamp_max(0.02 / pn.clamp_min(1e-9), 1.0)
        dpose_w = torch.cat([pos_cmd * 3.0, orn_err], dim=-1)
        u = control_ik(j_eef, dpose_w, damping=self.ik_damping)
        arm_target = dof_pos[:, :7] + u
        grip_target = (0.5 * tgt_sep)[:, None].expand(N, 2)
        pos_target = torch.cat([arm_target, grip_target], dim=-1)

        actions = self.sim.actions
        actions = actions._replace(
            dof_pos_target=actions.dof_pos_target.index_copy(1, self._dof, pos_target)
        )
        return actions, nxt, ang, err

    def step_fn(self, state: ScrewState, _=None):
        """FSM + IK control + physics. Returns (next ScrewState, (fsm before
        the step (N,), task-space error (N,)))."""
        actions, nxt, ang, err = self.control(state)
        st = self.sim.stepper.step(state.sim, actions, self.sim.params)
        return ScrewState(sim=st, fsm=nxt, screw_angle=ang), (state.fsm, err)

    # ------------------------------------------------------------------
    def rollout(self, num_steps: int, state: Optional[ScrewState] = None):
        """num_steps steps from `state` (init_state by default): (the end
        state, (fsm (num_steps, N), err (num_steps, N))) as the JAX
        package's lax.scan stacks them."""
        state = state or self.init_state
        fsm, err = [], []
        for _ in range(num_steps):
            state, (f, e) = self.step_fn(state)
            fsm.append(f)
            err.append(e)
        return state, (torch.stack(fsm), torch.stack(err))

    def nut_height_now(self, state: ScrewState):
        return state.sim.root_pos[:, self.nut_slot, 2]

"""The simulation step.

Port of test_isaacgym_tpu/physics/step.py for scenes of free and static
bodies: phase B (free-body velocities before contact), phase C (the contact
solve), the free-body half of phase D (integration) and the body-state
refresh, as plain functions of tensors:
    step(state, actions, params) -> state
Articulated groups, attractors and soft bodies are a later slice of the port;
a scene with any of them raises NotImplementedError at construction, as does
one whose static contact table has rows (only the sphere-world contact path
is ported).

`rollout` is a Python loop: PyTorch runs eagerly, and each step launches its
kernels on the current stream without waiting for them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.scene import Scene
from ..core.state import Actions, PhysParams, SimState
from ..math.quat import quat_integrate, quat_rotate, quat_to_matrix
from ..utils.linalg import spd_solve
from . import contacts as contacts_mod


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


class Stepper:
    def __init__(self, scene: Scene, device="cuda"):
        if scene.art_groups:
            raise NotImplementedError(
                "articulated actors are not ported to the torch package yet"
            )
        if scene.attractors:
            raise NotImplementedError("attractors are not ported to the torch package yet")
        if scene.soft is not None:
            raise NotImplementedError("soft bodies are not ported to the torch package yet")
        self.scene = scene
        self.device = torch.device(device)
        self.free = scene.free_group
        self.static = scene.static_group
        self.contact = contacts_mod.ContactSolver(scene)
        if self.contact.num_contacts:
            raise NotImplementedError(
                f"this scene has {self.contact.num_contacts} static contact rows: "
                "narrowphase and the contact-table solve are not ported to the "
                "torch package yet"
            )
        sp = scene.sim_params
        self.dt = sp.dt
        self.substeps = max(1, sp.substeps)
        self.h = sp.dt / self.substeps

        dev = self.device

        def index(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        # (slots, body slots) of the free and static groups, on the device
        self._groups = [
            (index(g.slots), index(g.body_slot))
            for g in (self.free, self.static)
            if g is not None and len(g.slots)
        ]
        if self.free is not None and self.free.count:
            self._fslots = index(self.free.slots)
            self._fbody = index(self.free.body_slot)
            self._lin_damp = f32(self.free.linear_damping)
            self._ang_damp = f32(self.free.angular_damping)
            self._max_lin = f32(self.free.max_linear_velocity)
            self._max_ang = f32(self.free.max_angular_velocity)

    # ------------------------------------------------------------------
    def step(self, state: SimState, actions: Actions, params: PhysParams) -> SimState:
        for _ in range(self.substeps):
            state = self._substep(state, actions, params)
        state = self.refresh_body_state(state, params)
        return state._replace(time=state.time + self.dt, steps=state.steps + 1)

    # ------------------------------------------------------------------
    def free_velocities(self, state: SimState, actions: Actions, params: PhysParams):
        """Phase B: free-body velocities after gravity, applied forces,
        gyroscopic torque and damping, before contact. Returns a dict of the
        free batch's tensors, or None when the scene has no free bodies."""
        if self.free is None or not self.free.count:
            return None
        h = self.h
        fslots, fbody = self._fslots, self._fbody
        p0 = state.root_pos[:, fslots]
        q0 = state.root_quat[:, fslots]
        v0 = state.root_linvel[:, fslots]
        w0 = state.root_angvel[:, fslots]
        m = params.body_mass[:, fbody]  # (N, F)
        com = params.body_com[:, fbody]
        I_l = params.body_inertia[:, fbody]
        no_grav = params.body_disable_gravity[:, fbody]

        F = actions.body_force[:, fbody]
        T = actions.body_torque[:, fbody]
        R = quat_to_matrix(q0)
        com_w = p0 + quat_rotate(q0, com)
        # force-at-pos: extra torque about com
        T = T + torch.where(
            actions.use_force_pos,
            _cross(actions.body_force_pos[:, fbody] - com_w, F),
            torch.zeros_like(T),
        )
        g_vec = params.gravity
        g_eff = torch.where(no_grav[..., None], torch.zeros_like(g_vec), g_vec)
        acc = F / m[..., None] + g_eff
        I_w = torch.einsum("...ij,...jk,...lk->...il", R, I_l, R)
        gyro = _cross(w0, torch.einsum("...ij,...j->...i", I_w, w0))
        wdot = spd_solve(I_w, T - gyro)

        v1 = (v0 + h * acc) * (1.0 - h * self._lin_damp).clamp_min(0.0)[..., None]
        w1 = (w0 + h * wdot) * (1.0 - h * self._ang_damp).clamp_min(0.0)[..., None]
        mlv = self._max_lin[..., None]
        mav = self._max_ang[..., None]
        v1 = torch.clamp(v1, -mlv, mlv)
        w1 = torch.clamp(w1, -mav, mav)
        return dict(p0=p0, q0=q0, v=v1, w=w1, m=m, I_w=I_w, com_w=com_w, com=com)

    def _substep(self, state: SimState, actions: Actions, params: PhysParams) -> SimState:
        h = self.h
        # ---------- phase B: free bodies — velocities (pre-contact) ----------
        fd = self.free_velocities(state, actions, params)

        # ---------- phase C: contact solve ----------
        # (enabled only with free bodies: a contact-table row raises at
        # construction, and both fast paths are made of free bodies)
        if self.contact.enabled:
            # CURRENT body positions: free roots at this substep's entry,
            # statics from the body cache
            cur_bp = state.body_pos.index_copy(1, self._fbody, fd["p0"])
            fd["v"], fd["w"], cf = self.contact.solve(
                cur_bp, fd["v"], fd["w"], fd["m"], fd["I_w"], params, h
            )
            state = state._replace(contact_force=cf)

        # ---------- phase D: position integration ----------
        if fd is None:
            return state
        v1, w1 = fd["v"], fd["w"]
        # integrate about com to respect com offsets
        com_w1 = fd["com_w"] + h * v_com(v1, w1, fd["com_w"], fd["p0"])
        q1 = quat_integrate(fd["q0"], w1, h)
        p1 = com_w1 - quat_rotate(q1, fd["com"])
        fs = self._fslots
        return state._replace(
            root_pos=state.root_pos.index_copy(1, fs, p1),
            root_quat=state.root_quat.index_copy(1, fs, q1),
            root_linvel=state.root_linvel.index_copy(1, fs, v1),
            root_angvel=state.root_angvel.index_copy(1, fs, w1),
        )

    # ------------------------------------------------------------------
    def refresh_body_state(self, state: SimState, params: PhysParams) -> SimState:
        """Recompute the per-body world state cache from the roots (the
        reference's refresh_rigid_body_state_tensor, now derived)."""
        body_pos = state.body_pos
        body_quat = state.body_quat
        body_lin = state.body_linvel
        body_ang = state.body_angvel
        for slots, body in self._groups:
            body_pos = body_pos.index_copy(1, body, state.root_pos[:, slots])
            body_quat = body_quat.index_copy(1, body, state.root_quat[:, slots])
            body_lin = body_lin.index_copy(1, body, state.root_linvel[:, slots])
            body_ang = body_ang.index_copy(1, body, state.root_angvel[:, slots])
        return state._replace(
            body_pos=body_pos,
            body_quat=body_quat,
            body_linvel=body_lin,
            body_angvel=body_ang,
        )

    # ------------------------------------------------------------------
    def rollout(self, state: SimState, actions: Actions, params: PhysParams, num_steps: int):
        """num_steps physics steps, as a loop."""
        for _ in range(num_steps):
            state = self.step(state, actions, params)
        return state


def v_com(v_origin, w, com_w, p_origin):
    """Velocity of the com point given origin velocity and angular velocity."""
    return v_origin + _cross(w, com_w - p_origin)

"""The simulation step.

Port of test_isaacgym_tpu/physics/step.py as plain functions of tensors:
    step(state, actions, params) -> state
with all substeps: phase A (articulated groups: drives with implicit PD,
external link forces, forward dynamics, joint friction), phase B (free-body
velocities before contact), phase C (the contact solve), phase D (limits and
position integration) and the body-state refresh. Attractors on
fixed-base articulations add their implicit spring-damper impulses in
phase A. A scene with `<fem>` links runs the XPBD soft solve
(physics/soft.py) after each rigid substep.

With TIG_DEBUG=1 (utils/debug.py) every substep's state is checked for
non-finite values, a host sync per substep that happens only then.

Contact impulses carry across substeps, and across steps in
`SimState.warm_n` / `warm_t` when `physx.warm_start_contacts` sized them.

`rollout` is a Python loop: PyTorch runs eagerly, and each step launches its
kernels on the current stream without waiting for them.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..core.scene import Scene
from ..core.state import Actions, PhysParams, SimState
from ..math.quat import (
    cross as _cross,
    orientation_error,
    quat_integrate,
    quat_mul,
    quat_rotate,
    quat_to_matrix,
)
from ..math.spatial import skew
from ..utils import debug as _debug
from ..utils.linalg import spd_inv, spd_solve
from ..utils.trace import span, stage
from . import contacts as contacts_mod
from . import dynamics
from .kinematics import ArtTopo, body_jacobian, fk, jacobian as link_jacobian, topo_from_group
from .soft import SoftStepper

DOF_MODE_NONE, DOF_MODE_POS, DOF_MODE_VEL, DOF_MODE_EFFORT = 0, 1, 2, 3


class _GroupIndex(NamedTuple):
    """Static index tensors, on the device, tying one ArtGroup into the
    canonical layout."""

    topo: ArtTopo
    slots: torch.Tensor  # (K,) actor slots
    dof_idx: torch.Tensor  # (K, Dg) into env dof axis
    dof_flat: torch.Tensor  # (K*Dg,) the same, flat
    body_flat: torch.Tensor  # (K*L_real,) env body of each real link, flat
    real_links: torch.Tensor  # (L_real,) sim-link indices that are real bodies
    link_body_idx: torch.Tensor  # (K, Ls) env body index per sim link (0 where synthetic)
    link_is_real: torch.Tensor  # (Ls,) bool
    all_real: bool  # every sim link is a real body (no spherical-joint expansion)


class _Attractor(NamedTuple):
    """One attractor resolved to its group copy and sim link, with its
    constants on the device."""

    t: int  # attractor index (the T axis of Actions / PhysParams)
    copy: int  # copy within the group
    copy_idx: torch.Tensor  # (1,) the same, for index_add
    link: int  # sim link within the group
    offset_pos: torch.Tensor  # (3,) attachment offset in the link frame
    offset_quat: torch.Tensor  # (4,)
    mask6: torch.Tensor  # (6,) f32 axes [x, y, z, swing1, swing2, twist]


class Stepper:
    def __init__(self, scene: Scene, device="cuda"):
        self.scene = scene
        self.device = torch.device(device)
        dev = self.device

        def index(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        self.groups: List[_GroupIndex] = []
        body_idxs = []  # (K, L_real) env body of each real link, per group
        for g in scene.art_groups:
            Dg = g.num_dofs
            dof_idx = g.dof_start[:, None] + np.arange(Dg)[None, :]
            real_links = np.array([i for i, b in enumerate(g.body_of_link) if b >= 0])
            body_idx = g.body_start[:, None] + g.body_of_link[None, real_links]
            body_idxs.append((body_idx, real_links))
            link_body = np.where(g.body_of_link >= 0, g.body_of_link, 0)
            link_body_idx = g.body_start[:, None] + link_body[None, :]
            link_is_real = np.asarray(g.body_of_link >= 0)
            self.groups.append(
                _GroupIndex(
                    topo=topo_from_group(g, dev),
                    slots=index(g.slots),
                    dof_idx=index(dof_idx),
                    dof_flat=index(dof_idx.reshape(-1)),
                    body_flat=index(body_idx.reshape(-1)),
                    real_links=index(real_links),
                    link_body_idx=index(link_body_idx),
                    link_is_real=torch.as_tensor(link_is_real, device=dev),
                    all_real=bool(link_is_real.all()),
                )
            )
        self.free = scene.free_group
        self.static = scene.static_group
        # attractors resolved to (group, copy, sim link): fixed-base
        # articulations only (the reference's usage: franka/kuka arms,
        # its examples/franka_attractor.py, kuka_bin.py:181-273)
        self.attractors_by_group: List[List[_Attractor]] = [[] for _ in self.groups]
        for t, a in enumerate(scene.attractors):
            placed = False
            for g_i, (gi, (body_idx, real_links)) in enumerate(zip(self.groups, body_idxs)):
                hits = np.argwhere(body_idx == a.body)
                if len(hits):
                    copy, real_i = hits[0]
                    if not gi.topo.fixed_base:
                        raise NotImplementedError(
                            "attractors on floating-base articulations"
                        )
                    mask6 = [float(bool(a.axes & (1 << k))) for k in range(6)]
                    self.attractors_by_group[g_i].append(_Attractor(
                        t=t, copy=int(copy), copy_idx=index([int(copy)]),
                        link=int(real_links[real_i]),
                        offset_pos=f32(np.asarray(a.offset_pos, np.float32)),
                        offset_quat=f32(np.asarray(a.offset_quat, np.float32)),
                        mask6=f32(mask6),
                    ))
                    placed = True
                    break
            if not placed:
                raise NotImplementedError(
                    "attractors are only supported on articulated bodies"
                )
        self._eye6 = torch.eye(6, dtype=torch.float32, device=dev)
        self.contact = contacts_mod.ContactSolver(scene, device=dev)
        self.soft = None
        if scene.soft is not None:
            with stage("setup.soft"):
                self.soft = SoftStepper(scene.soft, scene, dev)
        # groups whose links have contact rows: their Jacobians and inverse
        # implicit operators feed the solve
        self._group_has_rows = [len(ia) + len(ib) > 0 for ia, ib in self.contact.link_lists]
        sp = scene.sim_params
        self.dt = sp.dt
        self.substeps = max(1, sp.substeps)
        self.h = sp.dt / self.substeps
        self.debug = _debug.enabled()  # TIG_DEBUG=1

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
        with span("sim.step"):
            # body state is fresh at step entry (refresh_body_state runs at the
            # end of every step and after every state write), so the first
            # substep reuses it instead of re-running FK — with the final
            # refresh, 2 link sweeps per step instead of substeps+1.
            first = True
            # CROSS-STEP warm starting: persistent per-row contact impulses ride
            # in SimState (keyed by static contact row), so force chains (heavy
            # stacks, pinch grasps) keep converging across steps instead of
            # being rebuilt from zero; separated rows are masked to zero by the
            # solver's `active` gate on re-entry. Within a step the impulses
            # always carry from one substep to the next.
            warm = (state.warm_n, state.warm_t) if state.warm_n is not None else None
            for sub_i in range(self.substeps):
                state, warm = self._substep(
                    state, actions, params, reuse_body_state=first, warm=warm
                )
                if self.debug:
                    _debug.check_finite(state, f"substep {sub_i}")
                if self.soft is not None:
                    # one-way coupled FEM solve (physics/soft.py): soft verts see
                    # the body cache, which refreshes at step end, so the press
                    # lags the rigid substeps (as in the JAX package; invisible
                    # at 1/60)
                    with span("sim.soft"):
                        sp, sv = self.soft.substep(
                            state.soft_pos, state.soft_vel, state.body_pos, state.body_quat,
                            params, self.h, params.gravity,
                        )
                    state = state._replace(soft_pos=sp, soft_vel=sv)
                first = False
            state = self.refresh_body_state(state, params)
            if warm is not None and state.warm_n is not None:
                state = state._replace(warm_n=warm[0], warm_t=warm[1])
            return state._replace(time=state.time + self.dt, steps=state.steps + 1)

    def _link_state_from_bodies(self, gi: _GroupIndex, state: SimState):
        """Gather per-sim-link world state from the body cache (valid only
        when every sim link is a real body — no spherical-joint expansion)."""
        idx = gi.link_body_idx  # (K, Ls)
        return (
            state.body_pos[:, idx],
            state.body_quat[:, idx],
            state.body_linvel[:, idx],
            state.body_angvel[:, idx],
        )

    @staticmethod
    def _real(gi: _GroupIndex, x):
        """The real-body links of a per-sim-link tensor (..., Ls, ...) with the
        link axis third, flattened with the copy axis: (N, K*L_real, ...)."""
        if not gi.all_real:
            x = x[:, :, gi.real_links]
        return x.reshape((x.shape[0], -1) + tuple(x.shape[3:]))

    @staticmethod
    def _link_params(gi: _GroupIndex, per_body, default):
        """Per-sim-link values: the env body's runtime value on real links,
        `default` (a tensor or a number) on synthetic ones."""
        x = per_body[:, gi.link_body_idx]  # (N, K, Ls, ...)
        if gi.all_real:
            return x
        mask = gi.link_is_real.reshape((-1,) + (1,) * (x.dim() - 3))
        return torch.where(mask, x, default)

    # ------------------------------------------------------------------
    def group_velocities(self, state: SimState, actions: Actions, params: PhysParams,
                         reuse_body_state: bool = False):
        """Phase A: each articulated group's generalized velocity after
        drives, applied forces and forward dynamics, before contact.
        Returns one dict of the group's tensors per group."""
        h = self.h
        g_vec = params.gravity
        group_data = []
        for gi, attractors in zip(self.groups, self.attractors_by_group):
            topo = gi.topo
            base = 0 if topo.fixed_base else 6

            slots, didx = gi.slots, gi.dof_idx
            root_pos = state.root_pos[:, slots]  # (N, K, 3)
            root_quat = state.root_quat[:, slots]
            root_lin = state.root_linvel[:, slots]
            root_ang = state.root_angvel[:, slots]
            q = state.dof_pos[:, didx]  # (N, K, Dg)
            qd = state.dof_vel[:, didx]

            if reuse_body_state and gi.all_real:
                pos, quat, lin, ang = self._link_state_from_bodies(gi, state)
            else:
                pos, quat, lin, ang = fk(
                    topo, root_pos, root_quat, root_lin, root_ang, q, qd
                )

            # --- drives ---
            mode = params.dof_drive_mode[:, didx]
            kp = params.dof_stiffness[:, didx]
            kd = params.dof_damping[:, didx]
            q_t = actions.dof_pos_target[:, didx]
            v_t_raw = actions.dof_vel_target[:, didx]
            eff = actions.dof_effort[:, didx]
            max_eff = params.dof_max_effort[:, didx]

            kp_eff = torch.where(mode == DOF_MODE_POS, kp, 0.0)
            v_t = torch.where(mode == DOF_MODE_VEL, v_t_raw, 0.0)
            tau_raw = kp_eff * (q_t - q) + kd * (v_t - qd) - h * kp_eff * qd
            tau_drive = torch.clamp(tau_raw, -max_eff, max_eff)
            # implicit drive damping is only valid while the drive is linear;
            # in saturation the drive is a constant torque (PhysX-like force
            # limit), so the matrix term must vanish or it over-damps.
            sat_scale = torch.clamp(max_eff / tau_raw.abs().clamp_min(1e-9), 0.0, 1.0)
            tau_eff = torch.where(
                mode == DOF_MODE_EFFORT, torch.clamp(eff, -max_eff, max_eff), 0.0
            )
            tau_j = tau_drive + tau_eff
            d_eff_j = sat_scale * (kd + h * kp_eff)
            armature = params.dof_armature[:, didx]

            if base:
                zpad = torch.zeros(tau_j.shape[:-1] + (6,), dtype=tau_j.dtype,
                                   device=tau_j.device)
                tau = torch.cat([zpad, tau_j], dim=-1)
                d_eff = torch.cat([zpad, d_eff_j], dim=-1)
                diag_add = torch.cat([zpad, armature], dim=-1)
            else:
                tau, d_eff, diag_add = tau_j, d_eff_j, armature

            # --- external forces on links (ENV_SPACE world axes) ---
            bforce = self._link_params(gi, actions.body_force, 0.0)
            btorque = self._link_params(gi, actions.body_torque, 0.0)
            origin = pos[..., 0:1, :]
            arm = pos - origin
            f_ext = torch.cat(
                [btorque + _cross(arm, bforce), bforce], dim=-1
            )  # (N, K, Ls, 6) about root origin

            # runtime masses/inertia (randomizable): gather real-link params
            mass_l = self._link_params(gi, params.body_mass, topo.mass)
            com_l = self._link_params(gi, params.body_com, topo.com)
            inert_l = self._link_params(gi, params.body_inertia, topo.inertia)
            # gravity disable per body
            no_grav = self._link_params(gi, params.body_disable_gravity, False)
            # counteract gravity on disabled links via f_ext
            anti_g = mass_l[..., None] * g_vec * no_grav[..., None]
            com_world = pos + quat_rotate(quat, com_l)
            arm_c = com_world - origin
            f_ext = f_ext + torch.cat([_cross(arm_c, -anti_g), -anti_g], dim=-1)

            # armature adds to the mass-matrix diagonal: A = M + h*d_eff + armature
            qdd, M_full, A_op = dynamics.forward_dynamics(
                topo, pos, quat, lin, ang, qd, tau, h,
                d_eff=d_eff + diag_add / h,
                gravity=g_vec,
                mass=mass_l, com=com_l, inertia=inert_l,
                f_ext=f_ext,
                return_op=True,
            )

            # --- integrate joints (semi-implicit) ---
            qd_new = qd + h * qdd[..., base:]
            maxv = params.dof_max_velocity[:, didx]
            qd_new = torch.clamp(qd_new, -maxv, maxv)

            # joint Coulomb friction (DOF property `friction`): a friction
            # torque F can change joint velocity by at most F*h/M_jj in one
            # substep; removing min(|qd|, that) is the unconditionally stable
            # velocity-level form (never reverses sign)
            fric = params.dof_friction[:, didx]
            m_jj = torch.diagonal(M_full, dim1=-2, dim2=-1)[..., base:]
            dv_max = fric * h / m_jj.clamp_min(1e-9)
            qd_new = qd_new - torch.clamp(qd_new, -dv_max, dv_max)

            for att in attractors:
                qd_new = self._attractor_impulse(att, topo, pos, quat, M_full, qd_new,
                                                 actions, params)

            # assemble the generalized velocity vector matching the jacobian
            # column layout ([lin(3), ang(3), joints] for floating base)
            if topo.fixed_base:
                qd_full = qd_new
            else:
                v_new = root_lin + h * qdd[..., 0:3]
                w_new = root_ang + h * qdd[..., 3:6]
                qd_full = torch.cat([v_new, w_new, qd_new], dim=-1)
            group_data.append(
                dict(pos=pos, quat=quat, qd_full=qd_full, A_op=A_op, q=q,
                     root_pos=root_pos, root_quat=root_quat, base=base)
            )
        return group_data

    def _attractor_impulse(self, att: _Attractor, topo: ArtTopo, pos, quat, M_full,
                           qd_new, actions: Actions, params: PhysParams):
        """qd_new (N, K, Dg) after one attractor's implicit 6-DOF
        spring-damper impulse (stable at the reference's stiffness=5e5,
        its franka_attractor.py:151): the soft-constraint velocity solve
            (J M^-1 J^T + I/(h(hk+c))) lam = k*err/(hk+c) - v6
        applied as the joint-velocity impulse dqd = M^-1 J^T lam. M is phase
        A's mass matrix of the copy (the JAX package rebuilds the same CRBA
        from the same link poses and params)."""
        h = self.h
        c, t, link = att.copy, att.t, att.link
        M = M_full[:, c]  # (N, nv, nv); fixed base: nv == Dg
        J = body_jacobian(topo, pos[:, c], quat[:, c], link)
        p_l = pos[:, c, link]
        q_l = quat[:, c, link]
        p_att = p_l + quat_rotate(q_l, att.offset_pos)
        q_att = quat_mul(q_l, att.offset_quat)
        r = p_att - p_l
        J_p = J[:, :3] - skew(r) @ J[:, 3:]
        Jt = torch.cat([J_p, J[:, 3:]], dim=-2)  # (N, 6, nv)
        m6 = att.mask6
        Jm = m6[:, None] * Jt
        k_a = params.attractor_stiffness[:, t]
        c_a = params.attractor_damping[:, t]
        en = actions.attractor_enabled[:, t] & ((k_a + c_a) > 0)
        denom = (h * k_a + c_a).clamp_min(1e-9)
        gamma = 1.0 / (h * denom)
        err_p = actions.attractor_target_pos[:, t] - p_att
        err_r = orientation_error(actions.attractor_target_quat[:, t], q_att)
        err6 = torch.cat([err_p, err_r], dim=-1) * m6
        v6 = (Jt @ qd_new[:, c, :, None])[..., 0] * m6
        X = spd_solve(M, Jm.transpose(-1, -2))  # (N, nv, 6)
        W = Jm @ X
        A = W + (gamma[:, None] + (1.0 - m6))[..., None] * self._eye6
        rhs = (k_a / denom)[:, None] * err6 - v6
        lam = spd_solve(A, rhs) * m6
        # force limit (AttractorProperties.forceLimit)
        flim = params.attractor_force_limit[:, t]
        lnorm = torch.linalg.vector_norm(lam[:, :3], dim=-1).clamp_min(1e-9)
        scale = torch.clamp_max(flim * h / lnorm, 1.0)
        lam = lam * torch.where(torch.isfinite(flim), scale, 1.0)[:, None]
        lam = torch.where(en[:, None], lam, 0.0)
        dqd = (X @ lam[..., None])[..., 0]
        return qd_new.index_add(1, att.copy_idx, dqd[:, None])

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

    def contact_inputs(self, state: SimState, group_data, fd):
        """Phase C's inputs besides the velocities: CURRENT body poses
        (articulation links at this substep's FK, free roots at this
        substep's entry, statics from the cache) and, for each group with
        contact rows, its link Jacobians and inverse implicit operator
        (None for the others). Orientations are built only for a contact
        table or a neighbor world (the sphere world reads positions only)."""
        c = self.contact
        need_quat = c.num_contacts > 0 or c.neighbor_world is not None
        cur_bp, cur_bq = state.body_pos, state.body_quat
        for gi, gd in zip(self.groups, group_data):
            cur_bp = cur_bp.index_copy(1, gi.body_flat, self._real(gi, gd["pos"]))
            if need_quat:
                cur_bq = cur_bq.index_copy(1, gi.body_flat, self._real(gi, gd["quat"]))
        if fd is not None:
            cur_bp = cur_bp.index_copy(1, self._fbody, fd["p0"])
            if need_quat:
                cur_bq = cur_bq.index_copy(1, self._fbody, fd["q0"])
        art_jac, art_Ainv = [], []
        for gi, gd, rows in zip(self.groups, group_data, self._group_has_rows):
            art_jac.append(link_jacobian(gi.topo, gd["pos"], gd["quat"]) if rows else None)
            art_Ainv.append(spd_inv(gd["A_op"]) if rows else None)
        return cur_bp, cur_bq, art_jac, art_Ainv

    def _substep(self, state: SimState, actions: Actions, params: PhysParams,
                 reuse_body_state: bool = False, warm=None):
        h = self.h
        warm_out = warm
        # ---------- phase A: articulated groups — velocities (pre-contact) ----------
        with span("sim.phase_a"):
            group_data = self.group_velocities(state, actions, params, reuse_body_state)

        # ---------- phase B: free bodies — velocities (pre-contact) ----------
        with span("sim.phase_b"):
            fd = self.free_velocities(state, actions, params)

        # ---------- phase C: unified contact solve (free bodies + links) ----------
        if self.contact.enabled:
            with span("sim.phase_c"):
                cur_bp, cur_bq, art_jac, art_Ainv = self.contact_inputs(state, group_data, fd)
                fv, fw, qd_fulls, cf, warm_out = self.contact.solve(
                    cur_bp,
                    cur_bq,
                    (state.body_linvel, state.body_angvel),
                    fd["v"] if fd is not None else None,
                    fd["w"] if fd is not None else None,
                    fd["m"] if fd is not None else None,
                    fd["I_w"] if fd is not None else None,
                    fd["com_w"] if fd is not None else None,
                    [gd["qd_full"] for gd in group_data],
                    art_jac,
                    art_Ainv,
                    params,
                    h,
                    warm=warm,
                )
                state = state._replace(contact_force=cf)
                for gd, qd_full in zip(group_data, qd_fulls):
                    gd["qd_full"] = qd_full
                if fd is not None:
                    fd["v"], fd["w"] = fv, fw

        # ---------- phase D: limits + position integration ----------
        with span("sim.phase_d"):
            return self.integrate(state, group_data, fd, params), warm_out

    def integrate(self, state: SimState, group_data, fd, params: PhysParams) -> SimState:
        """Phase D: joint limits and position integration of the groups'
        and free bodies' post-contact velocities."""
        h = self.h
        root_pos, root_quat = state.root_pos, state.root_quat
        root_lin, root_ang = state.root_linvel, state.root_angvel
        dof_pos, dof_vel = state.dof_pos, state.dof_vel
        for gi, gd in zip(self.groups, group_data):
            base = gd["base"]
            didx = gi.dof_idx
            qd_new = gd["qd_full"][..., base:]
            q_new = gd["q"] + h * qd_new
            lo = params.dof_lower[:, didx]
            hi = params.dof_upper[:, didx]
            has_lim = params.dof_has_limits[:, didx]
            q_clamped = torch.clamp(q_new, lo, hi)
            hit_lo = has_lim & (q_new < lo)
            hit_hi = has_lim & (q_new > hi)
            q_new = torch.where(has_lim, q_clamped, q_new)
            qd_new = torch.where(hit_lo, qd_new.clamp_min(0.0), qd_new)
            qd_new = torch.where(hit_hi, qd_new.clamp_max(0.0), qd_new)
            n = q_new.shape[0]
            dof_vel = dof_vel.index_copy(1, gi.dof_flat, qd_new.reshape(n, -1))
            dof_pos = dof_pos.index_copy(1, gi.dof_flat, q_new.reshape(n, -1))
            if not gi.topo.fixed_base:
                slots = gi.slots
                v_new = gd["qd_full"][..., 0:3]
                w_new = gd["qd_full"][..., 3:6]
                root_lin = root_lin.index_copy(1, slots, v_new)
                root_ang = root_ang.index_copy(1, slots, w_new)
                root_pos = root_pos.index_copy(1, slots, gd["root_pos"] + h * v_new)
                root_quat = root_quat.index_copy(
                    1, slots, quat_integrate(gd["root_quat"], w_new, h)
                )

        if fd is not None:
            v1, w1 = fd["v"], fd["w"]
            # integrate about com to respect com offsets
            com_w1 = fd["com_w"] + h * v_com(v1, w1, fd["com_w"], fd["p0"])
            q1 = quat_integrate(fd["q0"], w1, h)
            p1 = com_w1 - quat_rotate(q1, fd["com"])
            fs = self._fslots
            root_pos = root_pos.index_copy(1, fs, p1)
            root_quat = root_quat.index_copy(1, fs, q1)
            root_lin = root_lin.index_copy(1, fs, v1)
            root_ang = root_ang.index_copy(1, fs, w1)

        return state._replace(
            root_pos=root_pos,
            root_quat=root_quat,
            root_linvel=root_lin,
            root_angvel=root_ang,
            dof_pos=dof_pos,
            dof_vel=dof_vel,
        )

    # ------------------------------------------------------------------
    def refresh_body_state(self, state: SimState, params: PhysParams) -> SimState:
        """Recompute the per-body world state cache from roots + dofs
        (the reference's refresh_rigid_body_state_tensor, now derived)."""
        with span("sim.refresh"):
            body_pos = state.body_pos
            body_quat = state.body_quat
            body_lin = state.body_linvel
            body_ang = state.body_angvel
            for gi in self.groups:
                slots, didx = gi.slots, gi.dof_idx
                pos, quat, lin, ang = fk(
                    gi.topo,
                    state.root_pos[:, slots],
                    state.root_quat[:, slots],
                    state.root_linvel[:, slots],
                    state.root_angvel[:, slots],
                    state.dof_pos[:, didx],
                    state.dof_vel[:, didx],
                )
                bidx = gi.body_flat
                body_pos = body_pos.index_copy(1, bidx, self._real(gi, pos))
                body_quat = body_quat.index_copy(1, bidx, self._real(gi, quat))
                body_lin = body_lin.index_copy(1, bidx, self._real(gi, lin))
                body_ang = body_ang.index_copy(1, bidx, self._real(gi, ang))
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

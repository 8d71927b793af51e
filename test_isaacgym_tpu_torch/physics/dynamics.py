"""Batched articulated forward dynamics: CRBA mass matrix + RNEA bias +
implicit-PD dense solve.

Port of test_isaacgym_tpu/physics/dynamics.py in its dense masked form only.
Instead of a sequential articulated-body algorithm it builds the dense
joint-space system

    (M(q) + h*D_eff) * qdd = tau_applied + tau_drive - C(q, qd) - g(q) + J^T f_ext

with M from the Composite Rigid Body Algorithm and C+g from RNEA (zero-accel
pass), both expressed in world axes about the actor root (small magnitudes,
f32-safe), and solves it with the unrolled batched Cholesky of
utils/linalg.py. D_eff folds drive damping (kd + h*kp) into the matrix: the
"stable PD" trick that keeps stiff drives stable at dt=1/60.

The JAX package also has a composite-unrolled form (hundreds of scalar ops a
chain, fused by XLA). Eager PyTorch pays one launch per op, so the port keeps
only the dense form: a handful of einsums over the static masks of
kinematics.TopoMasks. tests/test_torch_dynamics.py holds it against both
JAX forms.

All functions are batched over arbitrary leading axes.
"""
from __future__ import annotations

import torch

from ..math import spatial
from ..math.quat import cross as _cross, quat_rotate, quat_to_matrix
from ..utils.linalg import spd_solve
from ..utils.trace import span
from .kinematics import ArtTopo, joint_world_frames


def link_world_inertia(topo: ArtTopo, quat, mass=None, com=None, inertia=None):
    """World-frame (m, com_world_offset, Ic_world) per link.

    quat: (..., Ls, 4) link orientations. mass/com/inertia override the
    topology defaults (runtime body-property randomization); shapes
    (..., Ls)/(..., Ls, 3)/(..., Ls, 3, 3) in link frame.
    Returns com as offset from the LINK ORIGIN in world axes.
    """
    m = topo.mass if mass is None else mass
    c_l = topo.com if com is None else com
    i_l = topo.inertia if inertia is None else inertia
    # component form, as the JAX package computes it: (R I) R^T entry by entry
    R = quat_to_matrix(quat)  # (..., Ls, 3, 3)
    com_w = quat_rotate(quat, c_l.expand(quat.shape[:-1] + (3,)))
    Ib = i_l.expand(quat.shape[:-1] + (3, 3))
    Rc = [[R[..., a, b] for b in range(3)] for a in range(3)]
    Ic = [[Ib[..., a, b] for b in range(3)] for a in range(3)]
    B = [
        [sum(Rc[a][k] * Ic[k][b] for k in range(3)) for b in range(3)]
        for a in range(3)
    ]  # R @ I
    ic_w = torch.stack(
        [
            torch.stack(
                [sum(B[a][k] * Rc[b][k] for k in range(3)) for b in range(3)], -1
            )
            for a in range(3)
        ],
        -2,
    )  # (R I) @ R^T
    m = m.expand(quat.shape[:-1])
    return m, com_w, ic_w


def motion_subspaces(topo: ArtTopo, pos, quat, origin):
    """World-frame motion subspace column per link about `origin` (..., 3).

    Returns S (..., Ls, 6): [angular; linear] Featherstone convention, valid
    for links with a dof; zeros otherwise. Loop-free: one vectorized pass
    over the stacked joint frames.
    """
    mk = topo.masks
    anchors, axes = joint_world_frames(topo, pos, quat)
    rel = anchors - origin[..., None, :]  # (..., Ls, 3)
    s_ang = mk.is_rev[:, None] * axes
    s_lin = mk.is_rev[:, None] * _cross(rel, axes) + mk.is_pris[:, None] * axes
    return torch.cat([s_ang, s_lin], dim=-1)


def crba(topo: ArtTopo, S, m, com_rel, ic_w):
    """Mass matrix via the dense kinetic-energy identity M = sum_i J_i^T I_i J_i.

    The per-link Jacobian about the common origin O is J_i[:, d] =
    anc(i, d) * S_d (plus identity base columns), so the whole matrix reduces
    to a few einsums over static ancestor masks, exactly equal to the
    composite-rigid-body result.

    S: (..., Ls, 6) dof subspace columns about origin O.
    m/com_rel/ic_w: world inertia params per link; com_rel relative to O.
    Returns M (..., nv, nv), nv = [6+]D, base cols first for floating base.
    """
    with span("crba"):
        D = topo.num_dofs
        mk = topo.masks
        A = mk.dof_anc  # (L, D) static

        if D:
            Sd = S[..., mk.dof_link, :]  # (..., D, 6)
            # W[l, d] = I_l @ S_d  (spatial momentum of unit joint motion)
            W = spatial.inertia_mul(
                m[..., :, None],
                com_rel[..., :, None, :],
                ic_w[..., :, None, :, :],
                Sd[..., None, :, :],
            )  # (..., L, D, 6)
            G = torch.einsum("...ak,...lbk->...lab", Sd, W)
            Mjj = torch.einsum("la,lb,...lab->...ab", A, A, G)
        else:
            Mjj = torch.zeros(m.shape[:-1] + (0, 0), dtype=S.dtype, device=S.device)

        if topo.fixed_base:
            return Mjj

        # base block: total spatial inertia about O (explicit 6x6 in the
        # [translation rows; rotation rows] layout used by qdd[0:3]=lin,[3:6]=ang)
        m0 = torch.sum(m, dim=-1)
        msafe = m0.clamp_min(1e-12)
        c0 = torch.sum(m[..., None] * com_rel, dim=-2) / msafe[..., None]
        d = com_rel - c0[..., None, :]
        d2 = torch.sum(d * d, dim=-1)
        eye = torch.eye(3, dtype=S.dtype, device=S.device)
        outer = d[..., :, None] * d[..., None, :]
        i0 = torch.sum(
            ic_w + m[..., None, None] * (d2[..., None, None] * eye - outer), dim=-3
        )
        cx = spatial.skew(c0)
        tt = m0[..., None, None] * eye
        tr = -(m0[..., None, None] * cx)
        ccT = torch.einsum("...ij,...kj->...ik", cx, cx)
        rr = i0 + m0[..., None, None] * ccT

        if D:
            # base-joint coupling: F_d = sum_l anc(l,d) I_l S_d
            Fd = torch.einsum("ld,...ldk->...dk", A, W)  # (..., D, 6)
            jt_f = Fd[..., 3:6].transpose(-1, -2)  # (..., 3, D)
            jt_n = Fd[..., 0:3].transpose(-1, -2)
        else:
            jt_f = torch.zeros(tt.shape[:-1] + (0,), dtype=S.dtype, device=S.device)
            jt_n = torch.zeros(tt.shape[:-1] + (0,), dtype=S.dtype, device=S.device)

        top = torch.cat([tt, tr, jt_f], dim=-1)  # (..., 3, nv)
        mid = torch.cat([tr.transpose(-1, -2), rr, jt_n], dim=-1)
        if D:
            bot = torch.cat(
                [jt_f.transpose(-1, -2), jt_n.transpose(-1, -2), Mjj], dim=-1
            )  # (..., D, nv)
            return torch.cat([top, mid, bot], dim=-2)
        return torch.cat([top, mid], dim=-2)


def rnea_bias(topo: ArtTopo, S, m, com_rel, ic_w, vel_sp, qd, gravity, f_ext=None):
    """Bias generalized force C(q,qd)+g(q) - tau_ext about origin O.

    vel_sp: (..., Ls, 6) spatial velocity [w; v_O] of each link about O.
    qd: (..., D). gravity: (3,). f_ext: optional (..., Ls, 6) external spatial
    force on each link about O (world axes), entering with a minus sign.
    Returns (..., nv).
    """
    with span("rnea"):
        D = topo.num_dofs
        mk = topo.masks

        # bias acceleration (qdd = 0): a_i = -g + sum_{j in anc(i)} v_j x (S_j qd_j)
        g6 = torch.cat([torch.zeros_like(gravity), -gravity], dim=-1)
        if D:
            qd_l = qd[..., mk.link_qd] * mk.has_dof  # (..., L)
            c = spatial.cross_motion(vel_sp, S * qd_l[..., None])  # (..., L, 6)
            a = g6 + torch.einsum("ij,...jk->...ik", mk.anc, c)
        else:
            a = g6.expand(vel_sp.shape)

        Iv = spatial.inertia_mul(m, com_rel, ic_w, vel_sp)
        f = spatial.inertia_mul(m, com_rel, ic_w, a) + spatial.cross_force(vel_sp, Iv)
        if f_ext is not None:
            f = f - f_ext

        parts = []
        if not topo.fixed_base:
            f_tot = torch.sum(f, dim=-2)
            # base rows: translation rows pair with f, rotation rows with n
            parts.append(f_tot[..., 3:6])
            parts.append(f_tot[..., 0:3])
        if D:
            # C[d] = sum_{i desc of d} S_d . f_i
            Sd = S[..., mk.dof_link, :]
            parts.append(torch.einsum("ld,...dk,...lk->...d", mk.dof_anc, Sd, f))
        return torch.cat(parts, dim=-1)


def spatial_velocities(topo: ArtTopo, pos, lin, ang, origin):
    """Convert per-link (linvel-of-origin, angvel) to spatial [w; v_O] about O."""
    v_o = lin + _cross(ang, origin[..., None, :] - pos)
    return torch.cat([ang, v_o], dim=-1)


def forward_dynamics(
    topo: ArtTopo,
    pos,
    quat,
    lin,
    ang,
    dof_vel,
    tau,
    h: float,
    d_eff,
    gravity,
    mass=None,
    com=None,
    inertia=None,
    f_ext=None,
    base_wrench=None,
    return_op=False,
):
    """Solve (M + h*diag(d_eff)) qdd = tau - C - g + ext.

    pos/quat/lin/ang: link world states (..., Ls, .).
    tau: (..., nv) generalized applied force (base rows zero for floating).
    d_eff: (..., nv) implicit diagonal damping (kd + h*kp + joint damping + armature/h).
    f_ext: (..., Ls, 6) spatial external force per link about the root origin.
    base_wrench: optional (..., 6) [torque; force] world wrench on the base
    about the root, added to a floating base's rows (ignored for a fixed one).
    Returns (qdd (..., nv), M), and the operator A = M + h*diag(d_eff) too
    when return_op.
    """
    origin = pos[..., 0, :]
    m, com_w, ic_w = link_world_inertia(topo, quat, mass, com, inertia)
    com_rel = (pos - origin[..., None, :]) + com_w
    S = motion_subspaces(topo, pos, quat, origin)
    vel_sp = spatial_velocities(topo, pos, lin, ang, origin)
    M = crba(topo, S, m, com_rel, ic_w)
    C = rnea_bias(topo, S, m, com_rel, ic_w, vel_sp, dof_vel, gravity, f_ext)
    rhs = tau - C
    if base_wrench is not None and not topo.fixed_base:
        # the base rows are [linear; angular], the wrench [torque; force]
        rhs = torch.cat([rhs[..., 0:3] + base_wrench[..., 3:6],
                         rhs[..., 3:6] + base_wrench[..., 0:3], rhs[..., 6:]], dim=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    A = M + h * eye * d_eff[..., None, :]
    # batched SPD solve — unrolled Cholesky (utils/linalg.py)
    qdd = spd_solve(A, rhs)
    if return_op:
        # A is the implicit velocity-level operator: the contact solver uses
        # A^-1 so joint-space contact impulses feel the drives' implicit
        # damping (stable force-limited squeezing)
        return qdd, M, A
    return qdd, M


def mass_matrix(topo: ArtTopo, pos, quat, mass=None, com=None, inertia=None):
    """Standalone CRBA (acquire_mass_matrix_tensor capability)."""
    origin = pos[..., 0, :]
    m, com_w, ic_w = link_world_inertia(topo, quat, mass, com, inertia)
    com_rel = (pos - origin[..., None, :]) + com_w
    S = motion_subspaces(topo, pos, quat, origin)
    return crba(topo, S, m, com_rel, ic_w)

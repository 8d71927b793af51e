"""Batched articulated forward kinematics.

Port of test_isaacgym_tpu/physics/kinematics.py. Given root pose/velocity and
generalized coordinates, computes the world pose and velocity of every link.
The per-link loop runs in Python over the static topology (links <= ~32);
every op inside is batched over arbitrary leading axes (env, copy).

Velocities are carried as (omega_world, v_link_origin) pairs — no large-offset
spatial origins, safe in f32 for grid-spread envs.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.scene import JT_PRISMATIC, JT_REVOLUTE, JT_ROOT, ArtGroup
from ..math.quat import cross as _cross, quat_mul, quat_rotate


class TopoMasks(NamedTuple):
    """Static topology masks for the dense loop-free dynamics formulation,
    computed with numpy once per topology (`topo_masks`) and held as tensors
    on the topology's device. Kept tiny (L<=~32, D<=~32): the O(L*D) mask
    einsums cost negligible FLOPs and replace per-link scalar chains with a
    handful of batched contractions."""

    anc: torch.Tensor  # (L, L) f32: anc[i, j] = 1 if j is i or an ancestor of i
    dof_link: torch.Tensor  # (D,) long: link carrying each dof
    dof_anc: torch.Tensor  # (L, D) f32: dof_anc[i, d] = 1 if dof d moves link i
    is_rev: torch.Tensor  # (L,) f32
    is_pris: torch.Tensor  # (L,) f32
    has_dof: torch.Tensor  # (L,) f32
    link_qd: torch.Tensor  # (L,) long: dof index per link (0 where none; mask with has_dof)
    parent_or_self: torch.Tensor  # (L,) long: parent link, the link itself for the root
    is_root: torch.Tensor  # (L,) bool


def topo_masks(parent, jtype, dof_of_link, device) -> TopoMasks:
    """The masks of one topology (integer maps as sequences), on `device`."""
    L = len(parent)
    D = max([d for d in dof_of_link if d >= 0], default=-1) + 1
    anc = np.zeros((L, L), np.float32)
    for i in range(L):
        x = i
        while x != -1:
            anc[i, x] = 1.0
            x = parent[x]
    dof_link = np.zeros((max(D, 1),), np.int64)
    link_qd = np.zeros((L,), np.int64)
    has_dof = np.zeros((L,), np.float32)
    for i in range(L):
        d = dof_of_link[i]
        if d >= 0:
            dof_link[d] = i
            link_qd[i] = d
            has_dof[i] = 1.0
    dof_anc = anc[:, dof_link[:D]] if D else np.zeros((L, 0), np.float32)
    is_rev = np.array([1.0 if jt == JT_REVOLUTE else 0.0 for jt in jtype], np.float32)
    is_pris = np.array([1.0 if jt == JT_PRISMATIC else 0.0 for jt in jtype], np.float32)
    par = np.array([p if p >= 0 else i for i, p in enumerate(parent)], np.int64)
    is_root = np.array([jt == JT_ROOT for jt in jtype], bool)
    arrays = (anc, dof_link[:D], dof_anc, is_rev, is_pris, has_dof, link_qd, par, is_root)
    return TopoMasks(*(torch.as_tensor(a, device=device) for a in arrays))


class ArtTopo(NamedTuple):
    """Device-constant topology for one articulation group. Integer maps are
    Python tuples (they drive the per-link Python loop); the rest are tensors
    on one device, `masks` included."""

    parent: Tuple[int, ...]
    jtype: Tuple[int, ...]
    dof_of_link: Tuple[int, ...]
    body_of_link: Tuple[int, ...]
    axis: torch.Tensor  # (Ls, 3) in joint frame
    jp_pos: torch.Tensor  # (Ls, 3)
    jp_quat: torch.Tensor  # (Ls, 4)
    jc_pos: torch.Tensor  # (Ls, 3)
    jc_quat: torch.Tensor  # (Ls, 4)
    mass: torch.Tensor  # (Ls,) default (synthetic links keep these)
    com: torch.Tensor  # (Ls, 3)
    inertia: torch.Tensor  # (Ls, 3, 3)
    fixed_base: bool
    masks: TopoMasks

    @property
    def num_links(self):
        return len(self.parent)

    @property
    def num_dofs(self):
        return max([d for d in self.dof_of_link if d >= 0], default=-1) + 1


def topo_from_group(g: ArtGroup, device="cuda") -> ArtTopo:
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    parent = tuple(int(x) for x in g.parent)
    jtype = tuple(int(x) for x in g.jtype)
    dof_of_link = tuple(int(x) for x in g.dof_of_link)
    return ArtTopo(
        parent=parent,
        jtype=jtype,
        dof_of_link=dof_of_link,
        body_of_link=tuple(int(x) for x in g.body_of_link),
        axis=f32(g.axis),
        jp_pos=f32(g.jp_pos),
        jp_quat=f32(g.jp_quat),
        jc_pos=f32(g.jc_pos),
        jc_quat=f32(g.jc_quat),
        mass=f32(g.mass),
        com=f32(g.com),
        inertia=f32(g.inertia),
        fixed_base=bool(g.fixed_base),
        masks=topo_masks(parent, jtype, dof_of_link, device),
    )


def fk(
    topo: ArtTopo,
    root_pos,
    root_quat,
    root_linvel,
    root_angvel,
    dof_pos,
    dof_vel,
):
    """Forward kinematics for one articulation group.

    Inputs are batched: root_* (..., 3/4), dof_* (..., D).
    Returns (pos, quat, linvel, angvel) each (..., Ls, ...): world link frames,
    linvel = velocity of the link-frame origin, angvel = world angular velocity.
    """
    L = topo.num_links
    pos, quat, lin, ang = [], [], [], []
    for i in range(L):
        if topo.jtype[i] == JT_ROOT:
            pos.append(root_pos)
            quat.append(root_quat)
            lin.append(root_linvel)
            ang.append(root_angvel)
            continue
        p = topo.parent[i]
        # joint frame in world
        jf_pos = pos[p] + quat_rotate(quat[p], topo.jp_pos[i])
        jf_quat = quat_mul(quat[p], topo.jp_quat[i])
        d = topo.dof_of_link[i]
        jt = topo.jtype[i]
        if jt == JT_REVOLUTE:
            q_i = dof_pos[..., d]
            qd_i = dof_vel[..., d]
            half = 0.5 * q_i
            s, c = torch.sin(half), torch.cos(half)
            jq = torch.stack(
                [topo.axis[i, 0] * s, topo.axis[i, 1] * s, topo.axis[i, 2] * s, c],
                dim=-1,
            )
            post_quat = quat_mul(jf_quat, jq)
            axis_w = quat_rotate(jf_quat, topo.axis[i])
            body_quat = quat_mul(post_quat, topo.jc_quat[i])
            body_pos = jf_pos + quat_rotate(post_quat, topo.jc_pos[i])
            w = ang[p] + axis_w * qd_i[..., None]
            v = (
                lin[p]
                + _cross(ang[p], jf_pos - pos[p])
                + _cross(axis_w * qd_i[..., None], body_pos - jf_pos)
            )
        elif jt == JT_PRISMATIC:
            q_i = dof_pos[..., d]
            qd_i = dof_vel[..., d]
            axis_w = quat_rotate(jf_quat, topo.axis[i])
            body_quat = quat_mul(jf_quat, topo.jc_quat[i])
            body_pos = (
                jf_pos + axis_w * q_i[..., None] + quat_rotate(jf_quat, topo.jc_pos[i])
            )
            w = ang[p]
            v = lin[p] + _cross(ang[p], body_pos - pos[p]) + axis_w * qd_i[..., None]
        else:  # fixed
            body_quat = quat_mul(jf_quat, topo.jc_quat[i])
            body_pos = jf_pos + quat_rotate(jf_quat, topo.jc_pos[i])
            w = ang[p]
            v = lin[p] + _cross(ang[p], body_pos - pos[p])
        pos.append(body_pos)
        quat.append(body_quat)
        lin.append(v)
        ang.append(w)
    return (
        torch.stack(pos, dim=-2),
        torch.stack(quat, dim=-2),
        torch.stack(lin, dim=-2),
        torch.stack(ang, dim=-2),
    )


def joint_world_frames(topo: ArtTopo, pos, quat):
    """World joint anchor and axis for each link's inbound joint, given link
    world poses (..., Ls, 3/4). Anchor/axis of the root are its own frame.

    Vectorized over links: one gather on the parent index + batched quat ops."""
    mk = topo.masks
    pp = pos[..., mk.parent_or_self, :]
    pq = quat[..., mk.parent_or_self, :]
    jf_pos = pp + quat_rotate(pq, topo.jp_pos)
    jf_quat = quat_mul(pq, topo.jp_quat)
    root = mk.is_root[:, None]
    anchors = torch.where(root, pos, jf_pos)
    axes = torch.where(root, quat_rotate(quat, topo.axis), quat_rotate(jf_quat, topo.axis))
    return anchors, axes


def _jacobian_dense(topo: ArtTopo, pos, quat, link=None):
    """Dense loop-free geometric Jacobians.

    pos/quat: (..., Ls, 3/4). link: None for every link, or the index of one
    (kept as an axis of size 1). Returns (..., B, 6, nv) with rows
    [linvel(3); angvel(3)] of each selected link origin.
    """
    mk = topo.masks
    D = topo.num_dofs
    anchors, axes = joint_world_frames(topo, pos, quat)
    sel = slice(None) if link is None else slice(link, link + 1)
    body_pos = pos[..., sel, :]  # (..., B, 3)

    if D:
        axd = axes[..., mk.dof_link, :]  # (..., D, 3)
        anch_d = anchors[..., mk.dof_link, :]
        rev_d = mk.is_rev[mk.dof_link]  # (D,)
        pris_d = mk.is_pris[mk.dof_link]
        rel = body_pos[..., :, None, :] - anch_d[..., None, :, :]  # (..., B, D, 3)
        lin = rev_d[:, None] * _cross(
            axd[..., None, :, :].expand(rel.shape), rel
        ) + pris_d[:, None] * axd[..., None, :, :]
        ang = (rev_d[:, None] * axd)[..., None, :, :] + torch.zeros_like(rel)
        A = mk.dof_anc[sel]  # (B, D)
        Jj = torch.cat([lin, ang], dim=-1) * A[:, :, None]  # (..., B, D, 6)
        Jj = Jj.transpose(-1, -2)  # (..., B, 6, D)
    else:
        Jj = torch.zeros(body_pos.shape[:-1] + (6, 0), dtype=pos.dtype, device=pos.device)

    if topo.fixed_base:
        return Jj
    # base cols: translation k -> [e_k; 0]; rotation k -> [e_k x rel_b; e_k]
    rel_b = body_pos - pos[..., 0:1, :]  # (..., B, 3)
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    zero = torch.zeros(rel_b.shape[:-1] + (3, 3), dtype=pos.dtype, device=pos.device)
    trans = torch.cat([eye + zero, zero], dim=-2)  # (..., B, 6, 3)
    # lin rows of rotation cols: (e_k x rel)_r = -skew(rel)[r, k]
    rot_lin = _cross(eye.expand(rel_b.shape[:-1] + (3, 3)), rel_b[..., None, :])
    # (..., B, k, 3) — row k = e_k x rel
    rot = torch.cat([rot_lin.transpose(-1, -2), eye + zero], dim=-2)  # (..., B, 6, 3)
    return torch.cat([trans, rot, Jj], dim=-1)


def body_jacobian(topo: ArtTopo, pos, quat, link: int):
    """Jacobian of ONE link (..., 6, nv) — what task-space controllers need;
    avoids materializing the full per-link tensor in the hot loop."""
    return _jacobian_dense(topo, pos, quat, link=link)[..., 0, :, :]


def jacobian(topo: ArtTopo, pos, quat):
    """Geometric Jacobians for every link: (..., Ls, 6, nv) mapping generalized
    velocity to [linvel(3); angvel(3)] of each link origin.

    nv = D for fixed base, 6 + D for floating base (base cols first:
    [linear xyz, angular xyz] like IsaacGym's floating-base layout).
    """
    return _jacobian_dense(topo, pos, quat)

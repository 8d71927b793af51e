"""Plain reference of the Franka tracking cell: a fixed-base arm read from
its URDF file, under the operational-space control of Isaac Gym's
examples/franka_osc.py, stepped as the JAX package's
`envs/franka.py::FrankaOscEnv` and `physics/step.py::Stepper` step a
fixed-base arm without contact. It is written again from their arithmetic
(read, not imported) in plain PyTorch, with textbook algorithms of its own:
the mass matrix as the sum over links of J^T diag(m, I) J, the bias force
projected from each link's Newton-Euler equations (Kane's form), its
velocity-product accelerations by the outward recursion of rigid-body point
motion, and LU solves.

Per step: the OSC effort from the state at the step's start, then
`substeps` semi-implicit substeps of the joint-space dynamics
(M + h D + armature) qdd = tau - C(q, qd), with the fingers' position drive
implicit in D, velocities clipped to the joint limits', positions clamped
to the joint range (and a velocity into a bound zeroed). Every link has
gravity disabled (franka_osc.py's asset option), so gravity enters nowhere.
Positions are env-local: each arm's base sits at its env's origin, unrotated.
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from .precision import mm as matmul

REVOLUTE, PRISMATIC, FIXED = "revolute", "prismatic", "fixed"


class State(NamedTuple):
    dof_pos: torch.Tensor  # (N, D)
    dof_vel: torch.Tensor  # (N, D)
    steps: torch.Tensor  # () int: steps taken, the OSC target's clock


# ---------------------------------------------------------------- quaternions (x, y, z, w)
def qmul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def qmat(q):
    """(..., 3, 3) rotation matrix of a unit quaternion."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rpy_quat(r, p, y):
    """URDF's fixed-axis roll, pitch, yaw (R = Rz Ry Rx) as a quaternion."""
    def axis_q(k, a):
        v = [0.0, 0.0, 0.0]
        v[k] = math.sin(a / 2)
        return np.array(v + [math.cos(a / 2)])

    def mul(a, b):
        return qmul(torch.as_tensor(a, dtype=torch.float64),
                    torch.as_tensor(b, dtype=torch.float64)).numpy()

    return mul(mul(axis_q(2, y), axis_q(1, p)), axis_q(0, r))


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def gram(a, b):
    """(N, D, E): sum over links l and axes k of a[n, l, d, k] b[n, l, e, k]."""
    n, _, d, _ = a.shape
    return matmul(a.transpose(1, 2).reshape(n, d, -1),
                  b.transpose(1, 2).reshape(n, b.shape[2], -1).transpose(1, 2))


# ---------------------------------------------------------------- the URDF file
def _floats(text, default):
    return [float(x) for x in text.split()] if text else list(default)


def _origin(el):
    if el is None:
        return [0.0, 0.0, 0.0], np.array([0.0, 0.0, 0.0, 1.0])
    return _floats(el.get("xyz"), [0, 0, 0]), rpy_quat(*_floats(el.get("rpy"), [0, 0, 0]))


def read_urdf(path):
    """The tree of a URDF file as per-link lists, links in depth-first order
    from the root (children in file order), dofs numbered in link order.
    A link without <inertial> gets 1 g and 1e-6 kg m^2 (the importer's
    default that the stand-in's file states)."""
    root = ET.parse(path).getroot()
    links = {el.get("name"): el for el in root.findall("link")}
    joints = root.findall("joint")
    children = {}
    for j in joints:
        children.setdefault(j.find("parent").get("link"), []).append(j)
    base = next(n for n in links if all(j.find("child").get("link") != n for j in joints))
    out = {k: [] for k in ("name", "parent", "jtype", "jp_pos", "jp_quat", "axis", "mass", "com",
                           "inertia", "dof", "lower", "upper", "effort", "velocity")}
    def visit(name, parent, joint):
        el = links[name]
        jtype = FIXED if joint is None else joint.get("type")
        if jtype not in (REVOLUTE, PRISMATIC, FIXED):
            raise ValueError(f"joint type {jtype} of {name}")
        pos, quat = _origin(None if joint is None else joint.find("origin"))
        axis = np.array(_floats(None if joint is None or joint.find("axis") is None
                                else joint.find("axis").get("xyz"), [1, 0, 0]))
        inertial = el.find("inertial")
        if inertial is None:
            mass, com, inertia = 1e-3, [0.0, 0.0, 0.0], np.eye(3) * 1e-6
        else:
            mass = float(inertial.find("mass").get("value"))
            com, iq = _origin(inertial.find("origin"))
            a = {k: float(inertial.find("inertia").get(k, 0)) for k in
                 ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")}
            i_in = np.array([[a["ixx"], a["ixy"], a["ixz"]], [a["ixy"], a["iyy"], a["iyz"]],
                             [a["ixz"], a["iyz"], a["izz"]]])
            r = qmat(torch.as_tensor(iq)).numpy()
            inertia = r @ i_in @ r.T
        limit = None if joint is None else joint.find("limit")
        lim = {k: float(limit.get(k)) for k in ("lower", "upper", "effort", "velocity")} \
            if limit is not None else {"lower": -math.inf, "upper": math.inf,
                                       "effort": 1e9, "velocity": 1e9}
        for k, v in (("name", name), ("parent", parent), ("jtype", jtype), ("jp_pos", pos),
                     ("jp_quat", quat), ("axis", axis / np.linalg.norm(axis)), ("mass", mass),
                     ("com", com), ("inertia", inertia)):
            out[k].append(v)
        if jtype != FIXED:
            out["dof"].append(len(out["name"]) - 1)
            for k in ("lower", "upper", "effort", "velocity"):
                out[k].append(lim[k])
        me = len(out["name"]) - 1
        for j in children.get(name, []):
            visit(j.find("child").get("link"), me, j)

    visit(base, -1, None)
    return out


# ---------------------------------------------------------------- the arm
class FrankaTrack:
    """`num_envs` arms of the URDF file under franka_osc.py's OSC: the state
    of a step in, the state after it and the step's effort out."""

    def __init__(self, cfg: dict, urdf_path: str, device):
        t = read_urdf(urdf_path)
        self.device = device
        self.n = cfg["num_envs"]
        self.links = t["name"]
        self.parent = t["parent"]
        self.jtype = t["jtype"]
        self.dof_link = t["dof"]  # link of each dof
        self.hand = self.links.index(cfg["hand_link"])
        self.all_links = list(range(len(self.links)))
        L, D = len(self.links), len(self.dof_link)
        anc = np.zeros((L, D))  # anc[l, d]: dof d moves link l
        for d, ld in enumerate(self.dof_link):
            for l in range(L):
                x = l
                while x != -1 and x != ld:
                    x = self.parent[x]
                anc[l, d] = x == ld
        arm = cfg["arm_dofs"]
        drive = cfg["drive"]
        pos_mode = np.zeros(D, bool)
        pos_mode[arm:] = True  # the fingers: a position drive; the arm: effort
        c = {
            "jp_pos": np.array(t["jp_pos"]), "jp_quat": np.array(t["jp_quat"]),
            "axis": np.array(t["axis"]), "mass": np.array(t["mass"]), "com": np.array(t["com"]),
            "inertia": np.array(t["inertia"]), "anc": anc,
            "rev": np.array([self.jtype[l] == REVOLUTE for l in self.dof_link], float),
            "lower": np.array(t["lower"]), "upper": np.array(t["upper"]),
            "effort": np.array(t["effort"]), "vmax": np.array(t["velocity"]),
            "stiffness": np.where(pos_mode, drive["finger_stiffness"], 0.0),
            "damping": np.where(pos_mode, drive["finger_damping"], 0.0),
            "pos_mode": pos_mode.astype(float), "armature": np.full(D, drive["armature"]),
            "default": np.array(cfg["default_dof_pos"]),
        }
        self._c64 = {k: torch.as_tensor(v, dtype=torch.float64, device=device)
                     for k, v in c.items()}
        self._cast = {}
        self.kp, self.kv = cfg["kp"], cfg["kv"]
        self.h = cfg["dt"] / cfg["substeps"]
        self.substeps = cfg["substeps"]
        self.arm = arm
        self.target = cfg["osc_target"]
        # the circle's centre: the hand at the default pose
        q0 = self.c(torch.float64)["default"][None]
        pos, quat, *_ = self.kinematics(q0)
        self.init_hand = (pos[0, self.hand], quat[0, self.hand])

    def c(self, dtype):
        if dtype not in self._cast:
            self._cast[dtype] = {k: v.to(dtype) for k, v in self._c64.items()}
        return self._cast[dtype]

    # ---------------------------------------------------------------- kinematics
    def kinematics(self, q):
        """Link poses, COMs, world inertias, and each link's joint origin and
        axis in the world, of (N, D) joint positions: pos (N, L, 3), quat
        (N, L, 4), com (N, L, 3), inertia (N, L, 3, 3), joint and axis
        (N, L, 3)."""
        c = self.c(q.dtype)
        n = q.shape[0]
        pos, quat, rot, joint, axis = [], [], [], [], []
        dof_of = {l: d for d, l in enumerate(self.dof_link)}
        for l, p in enumerate(self.parent):
            if p < 0:
                lp, lq = q.new_zeros(n, 3), q.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(n, 4)
                jpos, ax = lp, q.new_zeros(n, 3)
            else:
                jpos = pos[p] + rot[p] @ c["jp_pos"][l]
                jquat = qmul(quat[p], c["jp_quat"][l].expand(n, 4))
                ax = qmat(jquat) @ c["axis"][l]
                lq, lp = jquat, jpos
                if self.jtype[l] == REVOLUTE:
                    half = q[:, dof_of[l]] / 2
                    lq = qmul(jquat, torch.cat([c["axis"][l] * torch.sin(half)[:, None],
                                                torch.cos(half)[:, None]], -1))
                elif self.jtype[l] == PRISMATIC:
                    lp = jpos + ax * q[:, dof_of[l], None]
            pos.append(lp)
            quat.append(lq)
            rot.append(qmat(lq))
            joint.append(jpos)
            axis.append(ax)
        pos, quat, rot = torch.stack(pos, 1), torch.stack(quat, 1), torch.stack(rot, 1)
        com = pos + (rot @ c["com"][..., None])[..., 0]
        inertia = matmul(matmul(rot, c["inertia"]), rot.transpose(-1, -2))
        return pos, quat, com, inertia, torch.stack(joint, 1), torch.stack(axis, 1)

    def jacobians(self, points, links, joint, axis):
        """(N, P, D, 3) linear and angular Jacobian columns of `points` (N, P,
        3), points[:, i] attached to link links[i]."""
        c = self.c(points.dtype)
        anchor, ax = joint[:, self.dof_link], axis[:, self.dof_link]
        rel = points[:, :, None, :] - anchor[:, None]
        ax = ax[:, None].expand_as(rel)
        rev, moves = c["rev"][:, None], c["anc"][links][..., None]
        return (rev * cross(ax, rel) + (1 - rev) * ax) * moves, rev * ax * moves

    def accelerations(self, qd, pos, com, joint, axis):
        """Each link's angular velocity w, and, with qdd = 0, its angular
        acceleration and its COM's acceleration (N, L, 3): the velocity
        product terms, by the outward recursion of rigid-body point motion."""
        w, al, acc = [], [], []
        dof_of = {l: d for d, l in enumerate(self.dof_link)}
        for l, p in enumerate(self.parent):
            if p < 0:
                zero = qd.new_zeros(qd.shape[0], 3)
                w.append(zero), al.append(zero), acc.append(zero)
                continue
            r = joint[:, l] - pos[:, p]
            a_joint = acc[p] + cross(al[p], r) + cross(w[p], cross(w[p], r))
            d = pos[:, l] - joint[:, l]
            wl, all_ = w[p], al[p]
            extra = 0.0
            if self.jtype[l] == REVOLUTE:
                s = axis[:, l] * qd[:, dof_of[l], None]
                wl, all_ = w[p] + s, al[p] + cross(w[p], s)
            elif self.jtype[l] == PRISMATIC:
                extra = 2 * cross(w[p], axis[:, l] * qd[:, dof_of[l], None])
            w.append(wl)
            al.append(all_)
            acc.append(a_joint + cross(all_, d) + cross(wl, cross(wl, d)) + extra)
        w, al, acc = torch.stack(w, 1), torch.stack(al, 1), torch.stack(acc, 1)
        rc = com - pos
        return w, al, acc + cross(al, rc) + cross(w, cross(w, rc))

    def dynamics(self, q, qd):
        """Mass matrix M (N, D, D) and bias force C (N, D) at (q, qd):
        M = sum over links of m Jv^T Jv + Jw^T I Jw at the COMs, and C the
        links' Newton-Euler forces of the velocity-product accelerations,
        projected by the same Jacobians."""
        pos, _, com, inertia, joint, axis = self.kinematics(q)
        jv, jw = self.jacobians(com, self.all_links, joint, axis)
        m = self.c(q.dtype)["mass"][:, None]
        w, alpha, acc = self.accelerations(qd, pos, com, joint, axis)
        mm = gram(jv * m[..., None], jv) + gram(matmul(jw, inertia), jw)
        iw = matmul(inertia, w[..., None])[..., 0]
        torque = matmul(inertia, alpha[..., None])[..., 0] + cross(w, iw)
        bias = (gram(jv, (m * acc)[:, :, None]) + gram(jw, torque[:, :, None]))[..., 0]
        return mm, bias

    def mass_matrix(self, q):
        _, _, com, inertia, joint, axis = self.kinematics(q)
        jv, jw = self.jacobians(com, self.all_links, joint, axis)
        m = self.c(q.dtype)["mass"][:, None, None]
        return gram(jv * m, jv) + gram(matmul(jw, inertia), jw)

    # ---------------------------------------------------------------- control and step
    def control(self, q, qd, steps):
        """franka_osc.py's OSC effort (N, D) tracking the circle; the
        position gain enters the task-space error and again the wrench,
        as in the JAX env."""
        pos, quat, _, _, joint, axis = self.kinematics(q)
        hp, hq = pos[:, self.hand], quat[:, self.hand]
        jv, jw = self.jacobians(pos[:, self.hand:self.hand + 1], [self.hand], joint, axis)
        a = self.arm
        j = torch.cat([jv[:, 0, :a].transpose(1, 2), jw[:, 0, :a].transpose(1, 2)], 1)  # (N, 6, A)
        mm = self.mass_matrix(q)[:, :a, :a]
        ip, iq = (x.to(q.dtype) for x in self.init_hand)
        tg = self.target
        t = steps.to(q.dtype)
        want = torch.stack([(ip[0] + tg["dx"]).expand_as(t),
                            tg["radius"] * torch.sin(t / tg["period"]),
                            ip[2] + tg["radius"] * torch.cos(t / tg["period"])]).expand_as(hp)
        err = qmul(iq.expand_as(hq), qconj(hq))
        orn = err[:, :3] * torch.sign(err[:, 3:])
        dpose = torch.cat([self.kp * (want - hp), orn], -1)
        jt = j.transpose(1, 2)
        lam_inv = matmul(j, torch.linalg.solve(mm, jt))
        u = (matmul(jt, torch.linalg.solve(lam_inv, self.kp * dpose[..., None]))
             - self.kv * matmul(mm, qd[:, :a, None]))[..., 0]
        return torch.cat([u, torch.zeros_like(qd[:, a:])], -1)

    def substep(self, q, qd, effort):
        c, h = self.c(q.dtype), self.h
        mm, bias = self.dynamics(q, qd)
        kp, kd, pm = c["stiffness"], c["damping"], c["pos_mode"]
        raw = kp * (c["default"] - q) - kd * qd - h * kp * qd
        lim = c["effort"]
        tau = torch.clamp(raw, -lim, lim) + (1 - pm) * torch.clamp(effort, -lim, lim)
        sat = torch.clamp(lim / raw.abs().clamp_min(1e-9), 0.0, 1.0)
        damp = sat * (kd + h * kp)
        a = mm + torch.diag_embed(h * damp + c["armature"])
        qdd = torch.linalg.solve(a, (tau - bias)[..., None])[..., 0]
        qd = torch.clamp(qd + h * qdd, -c["vmax"], c["vmax"])
        q1 = q + h * qd
        lo, hi = c["lower"], c["upper"]
        qd = torch.where(q1 < lo, qd.clamp_min(0.0), torch.where(q1 > hi, qd.clamp_max(0.0), qd))
        return torch.clamp(q1, lo, hi), qd

    def step(self, state: State, dtype=torch.float64):
        """(the state after one step, (the step's effort,))."""
        q, qd = state.dof_pos.to(dtype), state.dof_vel.to(dtype)
        effort = self.control(q, qd, state.steps)
        for _ in range(self.substeps):
            q, qd = self.substep(q, qd, effort)
        return State(q, qd, state.steps + 1), (effort,)

    def start(self, dof_offset):
        """The state of every arm at the default pose with its arm joints
        offset by `dof_offset` (N, arm dofs), at rest."""
        q = self.c(torch.float64)["default"].expand(self.n, -1).clone()
        q[:, :self.arm] += dof_offset.to(torch.float64)
        return State(q, torch.zeros_like(q), torch.zeros((), dtype=torch.int32, device=q.device))

    def fields(self, state: State, out):
        """The compared fields: joint state, the hand's env-local pose, and
        the effort of the step."""
        pos, quat, *_ = self.kinematics(state.dof_pos)
        f = {"dof_pos": state.dof_pos, "dof_vel": state.dof_vel,
             "hand_pos": pos[:, self.hand], "hand_quat": quat[:, self.hand]}
        if out is not None:
            f["effort"] = out[0]
        return f

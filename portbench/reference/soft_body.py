"""Plain reference of the soft-body press cell: Isaac Gym's
examples/soft_body.py, a tet-mesh icosphere on a `<fem>` link dropped under
the press plate of a prismatic rail held by a PD drive, stepped as the JAX
package's `physics/step.py::Stepper` and `physics/soft.py::SoftStepper`
step it. It is written again from their arithmetic (read, not imported) in
plain PyTorch, with algorithms of its own: each tet's deformation gradient
F = Ds Dm^-1 as products of 3 x 3 blocks with Dm^-1 from `torch.linalg.inv`, det(F)
by `torch.linalg.det` and its cofactor written out as crosses of F's
columns, per-vertex sums by scatter-adds (`index_add_`), the damping as a
scatter max over a vertex's tets, and the ground, box and friction
projections from their definitions.

Per step, `substeps` times: the rail's rigid substep (a one-dof prismatic
joint: M qdd = tau - C with the PD drive implicit, (M + h D) qdd = tau +
m g.axis, its velocity clipped to the joint's limit, its position clamped
to the joint's range), then one XPBD substep of every env's soft body:
predict under gravity, `iterations` Jacobi iterations of the two stable
Neo-Hookean constraints per tet (deviatoric C_D = |F|_F, hydrostatic C_H =
det F - (1 + mu/lambda), compliances 1 / (mu V h^2) and 1 / (lambda V h^2))
from the same positions, each tet's multiplier steps under-relaxed by
`relaxation` / the largest tet count of its corners, then the ground plane
and the press plate's box pushed out, both grown by the asset's thickness;
after the iterations one Coulomb position friction against the ground, the
velocity from the positions, and each vertex's velocity scaled by 1 - its
damping. The box takes the plate's pose at the step's start in every
substep (the JAX package's body cache refreshes at the step's end).

Departures from the published FleX solver: FleX's FEM is closed source,
so this is the repo's XPBD mapping of its iteration budget (outer x inner
iterations of Jacobi XPBD, `relaxation` as the under-relaxation); the
soft body is coupled one way (the plate does not feel it); the rail's
hold is an explicit PD drive where FleX holds the joint by itself.

Positions are world-frame, as the program's state is; `compared` gives
them env-local (each env's origin taken off) so that one scale serves
every env.
"""
from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from .precision import round_tf32


def mm(a, b):
    """a @ b of 3 x 3 blocks, broadcasting, as a product and a sum (a
    batched GEMM of 3 x 3 blocks is ~25x slower on the card); while TF32
    products are on (precision.tf32_matmuls: the control), of the operands
    rounded to TF32, as precision.mm computes them."""
    if torch.backends.cuda.matmul.allow_tf32:
        a, b = round_tf32(a), round_tf32(b)
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


class State(NamedTuple):
    soft_pos: torch.Tensor  # (N, V, 3) world
    soft_vel: torch.Tensor  # (N, V, 3)
    dof_pos: torch.Tensor  # (N, 1) the press rail
    dof_vel: torch.Tensor  # (N, 1)


def compared(state, origins, dt):
    """What the comparison holds each env to, from a state with soft_pos,
    soft_vel, dof_pos and dof_vel (the program's or this module's): the
    soft body's positions env-local, its velocities as the distance they
    carry a vertex in a step (soft_vel x dt, m), and the rail's position
    and velocity. A vertex's velocity is its last substep's displacement
    over h, so in m/s its float32 rounding would be the positions' times
    1/h; in metres a step both fields' rounding is of one size, and one
    limit holds both (PERF.md section 6)."""
    return {"soft_pos": state.soft_pos - origins[:, None], "soft_vel_dt": state.soft_vel * dt,
            "dof_pos": state.dof_pos, "dof_vel": state.dof_vel}


def read_tet(path):
    """(vertices (V, 3), tets (T, 4)) of a `.tet` file: `v x y z` and `t i j
    k l` lines, 0-based."""
    verts, tets = [], []
    with open(path) as f:
        for line in f:
            w = line.split()
            if w and w[0] == "v":
                verts.append([float(x) for x in w[1:4]])
            elif w and w[0] == "t":
                tets.append([int(x) for x in w[1:5]])
    return np.array(verts), np.array(tets, np.int64)


def _xyz(el, key, default="0 0 0"):
    return np.array([float(x) for x in (el.get(key) if el is not None and el.get(key)
                                          else default).split()])


def read_urdf(path):
    """What the cell runs by of the icosphere asset: the fem link's mesh,
    origin and density, the rail's axis, range and speed limit, and the
    plate's collision box (its size and offset). Every origin here is a
    translation: a rotation is refused."""
    robot = ET.parse(path).getroot()
    fem = robot.find("link/fem")
    rail = next(j for j in robot.findall("joint") if j.get("type") == "prismatic")
    plate = next(l for l in robot.findall("link") if l.get("name") == rail.find("child").get("link"))
    box = plate.find("collision")
    for el in (fem.find("origin"), box.find("origin"), rail.find("origin")):
        if el is not None and np.any(_xyz(el, "rpy")):
            raise ValueError(f"{path}: a rotated origin")
    limit = rail.find("limit")
    return {
        "tet": os.path.join(os.path.dirname(path), fem.find("tetmesh").get("filename")),
        "fem_origin": _xyz(fem.find("origin"), "xyz"),
        "density": float(fem.find("density").get("value")),
        "axis": _xyz(rail.find("axis"), "xyz"),
        "rail_origin": _xyz(rail.find("origin"), "xyz"),
        "range": (float(limit.get("lower")), float(limit.get("upper"))),
        "max_velocity": float(limit.get("velocity")),
        "box_size": _xyz(box.find("geometry/box"), "size"),
        "box_origin": _xyz(box.find("origin"), "xyz"),
    }


def env_origins(n, spacing):
    """Isaac Gym's create_env grid under Y-up: int(sqrt(n)) envs a row along
    x, rows along z, 2 x spacing apart."""
    per_row = max(int(math.sqrt(n)), 1)
    return np.array([[(i % per_row) * 2 * spacing, 0.0, (i // per_row) * 2 * spacing]
                     for i in range(n)])


class SoftPress:
    """The cell's envs: the mesh's constants, each env's materials, origin
    and press, in float64 on `device`."""

    def __init__(self, cfg, root, materials, device):
        f64 = dict(dtype=torch.float64, device=device)
        a = read_urdf(os.path.join(root, cfg["asset_root"], cfg["urdf"]))
        X, tets = read_tet(a["tet"])
        n = cfg["num_envs"]
        self.cfg, self.device = cfg, device
        self.h = cfg["dt"] / cfg["substeps"]
        self.iterations = cfg["flex"]["outer_iterations"] * cfg["flex"]["inner_iterations"]
        actor = np.array([0.0, cfg["drop_height"], 0.0])
        self.origins = torch.tensor(env_origins(n, cfg["env_spacing"]), **f64)
        self.rest = torch.tensor(X + actor + a["fem_origin"], **f64)  # (V, 3) in the env
        self.tets = torch.tensor(tets, device=device)  # (T, 4)
        V, T = len(X), len(tets)
        x = torch.tensor(X, **f64)[self.tets]  # (T, 4, 3)
        Dm = (x[:, 1:] - x[:, :1]).transpose(-1, -2)  # columns x_j - x_0
        self.dm_inv = torch.linalg.inv(Dm)
        self.volume = torch.linalg.det(Dm).abs() / 6
        flat = self.tets.reshape(-1)
        mass = torch.zeros(V, **f64).index_add_(
            0, flat, (a["density"] * self.volume / 4).repeat_interleave(4))
        self.inv_mass = 1.0 / mass.clamp(min=1e-9)
        count = torch.zeros(V, **f64).index_add_(0, flat, torch.ones(4 * T, **f64))
        self.jacobi = cfg["flex"]["relaxation"] / count[self.tets].amax(-1)  # (T,)
        self.youngs, self.poissons, self.damping = (
            torch.as_tensor(m, **f64) for m in materials)  # (N,) each
        g = cfg["ground"]
        self.normal = torch.tensor(g["normal"], **f64)
        self.plane, self.friction, self.margin = g["distance"], g["friction"], cfg["thickness"]
        self.gravity = torch.tensor(cfg["gravity"], **f64)
        self.axis = torch.tensor(a["axis"], **f64)
        # the plate's mass: its collision box at the asset's density (the
        # importer's default inertia for a link without <inertial>)
        self.plate_mass = float(np.prod(a["box_size"])) * cfg["asset_density"]
        self.range, self.max_velocity = a["range"], a["max_velocity"]
        self.box_offset = torch.tensor(actor + a["rail_origin"] + a["box_origin"], **f64)
        self.box_half = torch.tensor(a["box_size"] / 2 + cfg["thickness"], **f64)

    def start(self):
        n = self.origins.shape[0]
        z = torch.zeros((n, 1), dtype=torch.float64, device=self.device)
        pos = self.origins[:, None] + self.rest
        return State(pos, torch.zeros_like(pos), z, z.clone())

    def fields(self, state, out):
        return compared(state, self.origins, self.cfg["dt"])

    def step(self, state, dtype=torch.float64):
        x, v, q, qd = (t.to(device=self.device, dtype=dtype) for t in state)
        # the plate's centre this step: the rail's offset along its axis
        box = (self.origins + self.box_offset + q * self.axis).to(dtype)[:, None]  # (N, 1, 3)
        for _ in range(self.cfg["substeps"]):
            q, qd = self.rail(q, qd)
            x, v = self.soft_substep(x, v, box)
        return State(x, v, q, qd), ()

    def rail(self, q, qd):
        """The rail's semi-implicit substep under its PD drive (target 0,
        no actions) and gravity; the drive's damping and stiffness are
        implicit, and vanish from the operator where the effort saturates."""
        r, h, m = self.cfg["rail"], self.h, self.plate_mass
        kp, kd, effort = r["stiffness"], r["damping"], r["effort"]
        raw = kp * (r["target"] - q) - kd * qd - h * kp * qd
        tau = raw.clamp(-effort, effort)
        implicit = (effort / raw.abs().clamp(min=1e-9)).clamp(0.0, 1.0) * (kd + h * kp)
        weight = m * float(self.gravity @ self.axis)  # gravity's force along the axis
        qd = (qd + h * (tau + weight) / (m + h * implicit)).clamp(-self.max_velocity,
                                                                  self.max_velocity)
        q_new = q + h * qd
        lo, hi = self.range
        qd = torch.where(q_new < lo, qd.clamp(min=0.0), torch.where(q_new > hi,
                                                                     qd.clamp(max=0.0), qd))
        return q_new.clamp(lo, hi), qd

    def soft_substep(self, x, v, box):
        dtype = x.dtype
        h, T = self.h, self.tets.shape[0]
        E, nu = self.youngs.to(dtype)[:, None], self.poissons.to(dtype)[:, None]  # (N, 1)
        mu = E / (2 * (1 + nu))
        lam = E * nu / ((1 + nu) * (1 - 2 * nu))
        vol = self.volume.to(dtype)
        alpha_d = 1.0 / (mu * vol).clamp(min=1e-12) / (h * h)  # (N, T)
        alpha_h = 1.0 / (lam * vol).clamp(min=1e-12) / (h * h)
        gamma = 1.0 + mu / lam.clamp(min=1e-12)
        dm_inv, dm_inv_t = self.dm_inv.to(dtype), self.dm_inv.to(dtype).transpose(-1, -2)
        w = self.inv_mass.to(dtype)[self.tets]  # (T, 4)
        jac = self.jacobi.to(dtype)
        n = x.shape[0]

        v1 = v + h * self.gravity.to(dtype)
        p = x + h * v1
        lam_d = torch.zeros((n, T), dtype=dtype, device=x.device)
        lam_h = torch.zeros_like(lam_d)

        def corners(G):
            """(N, T, 4, 3) gradients of the corners from (dC/dF) Dm^-T,
            whose columns are corners 1-3's; corner 0's is minus their sum."""
            g = G.transpose(-1, -2)
            return torch.cat([-g.sum(-2, keepdim=True), g], -2)

        def multiplier(g, C, alpha, lam):
            wsum = (w * (g * g).sum(-1)).sum(-1)
            return -(C + alpha * lam) / (wsum + alpha).clamp(min=1e-9) * jac

        for _ in range(self.iterations):
            xt = p[:, self.tets]  # (N, T, 4, 3)
            F = mm((xt[:, :, 1:] - xt[:, :, :1]).transpose(-1, -2), dm_inv)
            norm = (F * F).sum((-2, -1)).clamp(min=1e-12).sqrt()
            gd = corners(mm(F / norm[..., None, None], dm_inv_t))
            c0, c1, c2 = F.unbind(-1)
            cof = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                               torch.linalg.cross(c0, c1)], -1)
            gh = corners(mm(cof, dm_inv_t))
            dl_d = multiplier(gd, norm, alpha_d, lam_d)
            dl_h = multiplier(gh, torch.linalg.det(F) - gamma, alpha_h, lam_h)
            lam_d, lam_h = lam_d + dl_d, lam_h + dl_h
            corr = w[..., None] * (gd * dl_d[..., None, None] + gh * dl_h[..., None, None])
            # each vertex's corrections summed first, then added once (added
            # one by one, world-frame positions would round at every term)
            p = p + torch.zeros_like(p).index_add_(1, self.tets.reshape(-1),
                                                   corr.reshape(n, 4 * T, 3))
            p = self.push_out(p, box)

        # Coulomb friction against the ground, once a substep: a vertex that
        # would have sunk by `approach` loses up to friction x approach of
        # its tangential motion
        nrm = self.normal.to(dtype)
        depth = x @ nrm - self.plane - self.margin
        approach = (-(depth + h * (v @ nrm))).clamp(min=0.0)
        motion = p - x
        tangent = motion - (motion @ nrm)[..., None] * nrm
        keep = (1.0 - self.friction * approach / tangent.norm(dim=-1).clamp(min=1e-9)).clamp(0, 1)
        p = p - torch.where((approach > 0)[..., None], (1.0 - keep[..., None]) * tangent, 0.0)

        v_new = (p - x) / h
        per_tet = self.damping.to(dtype)[:, None].expand(n, 4 * T)
        damp = torch.zeros(p.shape[:2], dtype=dtype, device=p.device).scatter_reduce(
            1, self.tets.reshape(-1).expand(n, -1), per_tet, "amax")
        return p, v_new * (1.0 - damp[..., None]).clamp(0.0, 1.0)

    def push_out(self, p, box):
        """The vertices below the ground plane moved onto it, then those
        inside the plate's box moved out through its nearest face; both
        surfaces grown by the margin."""
        nrm = self.normal.to(p.dtype)
        p = p - (p @ nrm - self.plane - self.margin).clamp(max=0.0)[..., None] * nrm
        half = self.box_half.to(p.dtype)
        rel = p - box
        room = half - rel.abs()  # > 0 on every axis: inside
        face = room.argmin(-1, keepdim=True)
        out = rel.scatter(-1, face, torch.sign(rel.gather(-1, face)) * half.expand_as(rel).gather(-1, face))
        return torch.where((room > 0).all(-1, keepdim=True), box + out, p)

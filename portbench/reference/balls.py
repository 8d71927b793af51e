"""Plain reference of the ball-pile cell: Isaac Gym's
examples/1080_balls_of_solitude.py --all_collisions, free spheres in one
collision world over a ground plane, stepped as the JAX package's
`physics/step.py::Stepper` steps free bodies and
`ops/sphere_world.py::_jnp_solve` solves their contacts. It is written
again from their arithmetic (read, not imported) in plain PyTorch.

Per step (one substep of h = dt): gravity on each ball's velocity (its
spin has no torque to change it), the velocities clipped to the asset's
maxima; then the contact solve; then the positions advanced by the new
velocities and the orientations by q + h/2 [w, 0] q, normalised.

The contact solve: every pair i < j of balls and every ball against the
plane is a contact row while its depth exceeds -contact_offset; the normal
points from j to i (up from the plane). A row's target normal velocity is
(depth - slop) / h below the slop, above it the larger of the Baumgarte
push beta (depth - slop) / h and the restitution bounce of an approach
faster than the bounce threshold. `iterations` Jacobi sweeps with
relaxation 0.8 update each row's accumulated normal impulse (kept >= 0)
and friction impulse along the current sliding direction (capped by mu
times the normal one), each ball taking its rows' impulses scaled by one
over its count of rows (mass splitting); the plane rows follow the pair
rows within each sweep, from the velocities they left. The net normal
impulse of a ball's rows over h is its contact force.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .franka import cross, qmul

BETA, RELAX = 0.2, 0.8


class State(NamedTuple):
    root_pos: torch.Tensor  # (N, F, 3) ball centres, N worlds of F balls
    root_quat: torch.Tensor  # (N, F, 4) x, y, z, w
    root_linvel: torch.Tensor
    root_angvel: torch.Tensor


def pyramid_positions(cfg: dict, seed: int) -> np.ndarray:
    """(F, 3) ball centres: `pyramids` pyramids of `base` x `base` layers on
    a square grid of `cell` m pitch, each pyramid moved by a jitter uniform
    within +-jitter m in x and y drawn by numpy's RandomState(seed) for all
    pyramids at once, balls 2.5 radii apart, the lowest layer at `z0` m."""
    pyr, r = cfg["pyramids"], cfg["radius"]
    lay = cfg["layout"]
    jitter = np.random.RandomState(seed).uniform(-lay["jitter"], lay["jitter"], (pyr, 2))
    spacing, grid = 2.5 * r, int(math.ceil(math.sqrt(pyr)))
    out = []
    for p in range(pyr):
        cx = (p % grid - (grid - 1) / 2) * lay["cell"] + jitter[p, 0]
        cy = (p // grid - (grid - 1) / 2) * lay["cell"] + jitter[p, 1]
        n, z = cfg["base"], lay["z0"]
        while n > 0:
            m = -0.5 * (n - 1) * spacing
            out += [(cx + m + i * spacing, cy + m + j * spacing, z)
                    for i in range(n) for j in range(n)]
            z += spacing
            n -= 1
    return np.array(out)


class BallPile:
    """`worlds` identical worlds of the configuration's balls."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.device = cfg, device
        self.centres = torch.as_tensor(pyramid_positions(cfg, seed), dtype=torch.float64,
                                       device=device)
        self.worlds = cfg["worlds"]
        r, px = cfg["radius"], cfg["physx"]
        mass = cfg["density"] * 4.0 / 3.0 * math.pi * r ** 3
        self.ball = {"r": r, "inv_m": 1.0 / mass, "inv_i": 1.0 / (0.4 * mass * r * r)}
        self.h = cfg["dt"]
        # the JAX package's count of sweeps for the sphere world
        self.iterations = max(6, 2 * px["position_iterations"]) + px["velocity_iterations"]
        self.offset, self.slop = px["contact_offset"], px["rest_offset"] + px["contact_slop"]
        self.bounce = px["bounce_threshold_velocity"]

    def start(self):
        p = self.centres.expand(self.worlds, -1, -1).clone()
        quat = torch.zeros(p.shape[:-1] + (4,), dtype=p.dtype, device=p.device)
        quat[..., 3] = 1
        return State(p, quat, torch.zeros_like(p), torch.zeros_like(p))

    def step(self, state: State, dtype=torch.float64):
        """(the state after one step, (each ball's contact force,))."""
        cfg, h = self.cfg, self.h
        p, q, v, w = (x.to(dtype) for x in state)
        g = torch.tensor(cfg["gravity"], dtype=dtype, device=p.device)
        lim = cfg["max_velocity"]
        v = torch.clamp(v + h * g, -lim["linear"], lim["linear"])
        w = torch.clamp(w, -lim["angular"], lim["angular"])
        v, w, force = self.contacts(p, v, w)
        q = q + 0.5 * h * qmul(torch.cat([w, torch.zeros_like(w[..., :1])], -1), q)
        q = q / q.norm(dim=-1, keepdim=True)
        return State(p + h * v, q, v, w), (force,)

    def contacts(self, p, v, w):
        cfg, h, b = self.cfg, self.h, self.ball
        r, im, ii = b["r"], b["inv_m"], b["inv_i"]
        f = p.shape[1]
        plane = cfg["ground"]
        pn = torch.tensor(plane["normal"], dtype=p.dtype, device=p.device)
        pn = pn / pn.norm()
        mu, rest = cfg["friction"], cfg["restitution"]
        mu_p, rest_p = mu, rest  # the average of two balls' materials
        mu_g, rest_g = 0.5 * (mu + plane["friction"]), 0.5 * (rest + plane["restitution"])

        diff = p[:, :, None] - p[:, None]  # x_i - x_j
        dist = diff.norm(dim=-1).clamp_min(1e-9)
        n = diff / dist[..., None]
        depth = 2 * r - dist
        upper = torch.ones(f, f, dtype=torch.bool, device=p.device).triu(1)
        on = upper & (depth > -self.offset)
        depth_g = r - ((p * pn).sum(-1) - plane["distance"])
        on_g = depth_g > -self.offset
        rows = on.sum(2) + on.sum(1) + on_g
        share = 1.0 / rows.clamp_min(1).to(p.dtype)  # (N, F)

        def surface_vel(v, w):  # i's surface against j's at the contact
            return v[:, :, None] - v[:, None] - cross(r * (w[:, :, None] + w[:, None]), n)

        def target(depth, vn0, rest):
            push = BETA / h * (depth - self.slop).clamp_min(0.0)
            bounce = torch.where(vn0 < -self.bounce, -rest * vn0, torch.zeros_like(vn0))
            return torch.where(depth > self.slop, torch.maximum(push, bounce),
                               (depth - self.slop) / h)

        k_n, k_t = 1.0 / (2 * im), 1.0 / (2 * im + 2 * r * r * ii)
        k_ng, k_tg = 1.0 / im, 1.0 / (im + r * r * ii)
        tgt = target(depth, (surface_vel(v, w) * n).sum(-1), rest_p)
        tgt_g = target(depth_g, (v * pn).sum(-1), rest_g)
        lam, lam_t = torch.zeros_like(depth), torch.zeros_like(depth)
        lam_g, lam_tg = torch.zeros_like(depth_g), torch.zeros_like(depth_g)
        for _ in range(self.iterations):
            vr = surface_vel(v, w)
            vn = (vr * n).sum(-1)
            dn = torch.where(on, (lam + RELAX * k_n * (tgt - vn)).clamp_min(0.0) - lam, 0.0)
            lam = lam + dn
            vt = vr - vn[..., None] * n
            speed = vt.norm(dim=-1).clamp_min(1e-9)
            dt_ = torch.where(on, torch.minimum(lam_t + RELAX * k_t * speed, mu_p * lam) - lam_t, 0.0)
            lam_t = lam_t + dt_
            imp = dn[..., None] * n - dt_[..., None] * vt / speed[..., None]
            # i takes +imp, j takes -imp; each at -r n (i) and +r n (j) from its centre
            v = v + im * share[..., None] * (imp.sum(2) - imp.sum(1))
            tq = cross(n, imp)
            w = w - r * ii * share[..., None] * (tq.sum(2) + tq.sum(1))

            vr_g = v - r * cross(w, pn.expand_as(w))
            vn_g = (vr_g * pn).sum(-1)
            dn_g = torch.where(on_g, (lam_g + RELAX * k_ng * (tgt_g - vn_g)).clamp_min(0.0) - lam_g,
                               0.0)
            lam_g = lam_g + dn_g
            vt_g = vr_g - vn_g[..., None] * pn
            speed_g = vt_g.norm(dim=-1).clamp_min(1e-9)
            dt_g = torch.where(on_g, torch.minimum(lam_tg + RELAX * k_tg * speed_g, mu_g * lam_g)
                               - lam_tg, 0.0)
            lam_tg = lam_tg + dt_g
            imp_g = dn_g[..., None] * pn - dt_g[..., None] * vt_g / speed_g[..., None]
            v = v + im * share[..., None] * imp_g
            w = w + ii * share[..., None] * cross(-r * pn.expand_as(imp_g), imp_g)
        fn = (lam[..., None] * n) / h
        return v, w, fn.sum(2) - fn.sum(1) + (lam_g / h)[..., None] * pn

    def fields(self, state: State, out):
        """Per ball (the unit of the comparison), over every world."""
        f = dict(zip(("pos", "quat", "vel", "angvel"), state))
        if out is not None:
            f["contact_force"] = out[0]
        return {k: x.reshape(-1, x.shape[-1]) for k, x in f.items()}

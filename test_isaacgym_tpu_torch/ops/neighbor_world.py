"""Neighbor-list contacts for LARGE mixed free-body worlds (boxes + spheres).

Port of test_isaacgym_tpu/ops/neighbor_world.py. The static contact table
(physics/contacts.py) is O(n^2) in pair rows: fine for a few dozen actors,
impossible for the reference's 1000-body single-collision-group scenes
when they are not pure spheres (its examples/projectiles.py:120 group -1
semantics at 1080_balls_of_solitude.py scale). Pure spheres take the dense
path (ops/sphere_world.py); this module covers the general free-body case:

  broadphase  — dense (F, F) center distances minus bounding radii, then
                each row keeps its K nearest admissible partners with j > i:
                a fixed-shape (F, K) neighbor list rebuilt every substep;
  narrowphase — per (i, j) candidate: sphere-sphere and sphere-box closest
                points, box-box pair-level SAT (6 face and 9 edge-cross
                axes) with a 4-corner manifold;
  solver      — mass-split relaxed Jacobi over the F*K*4 + F*8 contact rows
                with accumulated normal and Coulomb-cone friction impulses,
                the math of physics/contacts.py.

`build_spec` decides, exactly as the JAX package does, which free bodies
leave the static contact table for this path. `solve` is plain PyTorch, as
the JAX package's is jnp: no Pallas kernel reaches it. Two of its choices
depend on order, and follow `lax.top_k`, which puts the lower index first
among equal values: the neighbor list and the manifold's corners are picked
by a stable sort. Its scatter-adds into the (F,) velocity rows use atomics
on the GPU, so two solves of the same inputs there may differ in the last
bits.

Conventions match contacts.py: normal points j -> i (b -> a), Baumgarte
beta=0.2, speculative targets below the slop depth, PhysX AVERAGE combine.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..math.quat import cross, quat_rotate, quat_rotate_inverse, quat_to_matrix

# single-shape free bodies a world needs before it takes the neighbor-list
# path, and the neighbors kept per body (the JAX package's values)
MIN_BODIES = 64
K_NEIGHBORS = 12
# contact slots of one candidate pair (the box-box manifold's corners)
MANIFOLD = 4
# the score of a pair that may not collide, and the depth of an inert row
BIG = 1e30


class NeighborWorldSpec(NamedTuple):
    """Static description of one env's large free-body world."""

    shape_idx: np.ndarray  # (F,) env shape indices
    free_idx: np.ndarray  # (F,) free-body batch indices
    body_slot: np.ndarray  # (F,) env body slots
    is_box: np.ndarray  # (F,) bool (False = sphere)
    allow: np.ndarray  # (F, F) bool, j > i collidable pairs
    k_neighbors: int
    ground_spheres: bool  # False: sphere ground rows owned elsewhere
    has_ground: bool
    plane_n: np.ndarray  # (3,)
    plane_d: float
    plane_friction: float
    plane_restitution: float
    # local shape offset/rotation in the body frame (projectiles.py-style
    # worlds carry shape origins — the reference's examples/projectiles.py:120).
    # Identity rows are the common case and fold away in the fused pose math.
    local_pos: np.ndarray = None  # (F, 3)
    local_quat: np.ndarray = None  # (F, 4)

    def to(self, device) -> "NeighborWorldSpec":
        """The spec with the arrays `solve` reads (allow, is_box, plane_n,
        local_quat) as tensors on `device`: made once by a caller that
        solves many times, so no solve uploads them."""
        return self._replace(
            allow=torch.as_tensor(self.allow, device=device),
            is_box=torch.as_tensor(self.is_box, device=device),
            plane_n=torch.as_tensor(self.plane_n, dtype=torch.float32, device=device),
            local_quat=torch.as_tensor(self.local_quat, dtype=torch.float32, device=device),
        )


def build_spec(scene, exclude_sphere_pairs: bool = False) -> Optional[NeighborWorldSpec]:
    """Pick the single-shape sphere/box free bodies of `scene` when there
    are at least MIN_BODIES of them AND they are not a pure-sphere set
    (pure spheres take the dense path in sphere_world).

    With exclude_sphere_pairs=True (the sphere-world path coexists) this
    spec skips sphere-sphere pairs and sphere ground rows — it handles only
    the pairs that involve a box."""
    from ..core.scene import SHAPE_BOX, SHAPE_SPHERE

    fg = scene.free_group
    if fg is None:
        return None
    sh = scene.shapes
    rows = []
    for fi, b in enumerate(fg.body_slot):
        s = np.nonzero(sh.body_slot == b)[0]
        # single-shape sphere/box free bodies; local shape offset/rotation
        # is allowed (folded into the per-substep pose math, for
        # projectiles.py-style shape origins).
        # BUT the fused pose math treats the shape center as the COM
        # (inertia arms, vc = v + w x arm), so a link whose explicit
        # <inertial> COM is NOT at the geom origin must take the general
        # path or its torque arms are about the wrong point. Auto-derived
        # inertia stays eligible: there the geom center IS the physical
        # COM by construction.
        if len(s) == 1 and sh.kind[s[0]] in (SHAPE_SPHERE, SHAPE_BOX):
            link = scene.actors[fg.slots[fi]].asset.links[0]
            if getattr(link, "explicit_inertial", False) and (
                np.linalg.norm(scene.body_com[b] - sh.pos[s[0]]) > 1e-6
            ):
                continue
            rows.append((int(s[0]), fi, int(b), sh.kind[s[0]] == SHAPE_BOX))
    if len(rows) < MIN_BODIES or not any(r[3] for r in rows):
        return None
    shape_idx = np.array([r[0] for r in rows], np.int32)
    free_idx = np.array([r[1] for r in rows], np.int32)
    body_slot = np.array([r[2] for r in rows], np.int32)
    is_box = np.array([r[3] for r in rows], bool)
    local_pos = np.asarray(sh.pos[shape_idx], np.float32)
    local_quat = np.asarray(sh.quat[shape_idx], np.float32)

    grp = sh.collision_group[shape_idx]
    flt = sh.collision_filter[shape_idx]
    gi, gj = grp[:, None], grp[None, :]
    allow = (gi == gj) | (gi == -1) | (gj == -1)
    allow &= (flt[:, None] & flt[None, :]) == 0
    allow &= np.triu(np.ones_like(allow), 1) > 0  # each pair once, j > i
    if exclude_sphere_pairs:
        allow &= is_box[:, None] | is_box[None, :]

    has_ground = scene.ground is not None and scene.heightfield is None
    if has_ground:
        n = np.asarray(scene.ground.normal, np.float32)
        n = n / max(np.linalg.norm(n), 1e-9)
        pd = float(scene.ground.distance)
        pf = float(scene.ground.static_friction)
        pr = float(scene.ground.restitution)
    else:
        n, pd, pf, pr = np.array([0, 0, 1], np.float32), 0.0, 1.0, 0.0
    return NeighborWorldSpec(
        shape_idx=shape_idx,
        free_idx=free_idx,
        body_slot=body_slot,
        is_box=is_box,
        allow=np.asarray(allow, bool),
        k_neighbors=int(min(K_NEIGHBORS, len(rows) - 1)),
        ground_spheres=not exclude_sphere_pairs,
        has_ground=has_ground,
        plane_n=n,
        plane_d=pd,
        plane_friction=pf,
        plane_restitution=pr,
        local_pos=local_pos,
        local_quat=local_quat,
    )


def _point_in_box(rel, half):
    """Signed distance + outward local normal of points vs a box.
    rel (..., 3) point in box local frame, half (..., 3)."""
    q = rel.abs() - half
    outside = torch.linalg.vector_norm(q.clamp_min(0.0), dim=-1)
    inside = q.max(-1).values.clamp_max(0.0)
    sd = outside + inside
    # normal: gradient direction (outside: toward point from clamp;
    # inside: dominant axis)
    clamp = torch.clamp(rel, -half, half)
    d_out = rel - clamp
    ax = torch.argmax(q, dim=-1, keepdim=True)
    n_in = torch.zeros_like(rel).scatter(-1, ax, torch.sign(torch.gather(rel, -1, ax)))
    use_out = outside > 1e-9
    n = torch.where(use_out[..., None], d_out / outside.clamp_min(1e-9)[..., None], n_in)
    return sd, n, clamp


def _dot(a, b):
    """a . b over the last axis (3), summed in order: how jnp.einsum rounds
    a product of two operands of one shape on the CPU."""
    return (a * b).sum(-1)


def _fdot(a, b):
    """a . b over the last axis (3) as the chain of fused multiply-adds
    fma(a2, b2, fma(a1, b1, a0 * b0)): how jnp.einsum rounds it on the CPU
    where it is a matrix product (one operand broadcast against the other).
    Each fma is computed in float64, where a float32 product is exact, and
    rounded once to float32.

    Where two boxes lie face on face, eight corners tie in depth up to the
    last bits and the manifold keeps four of them: the port rounds the dot
    products that decide which as the JAX package does, so both keep the
    same corners."""
    a, b = torch.broadcast_tensors(a, b)
    a64, b64 = a.double(), b.double()
    s = a[..., 0] * b[..., 0]
    s = (a64[..., 1] * b64[..., 1] + s.double()).to(a.dtype)
    return (a64[..., 2] * b64[..., 2] + s.double()).to(a.dtype)


def _take(x, idx):
    """x (N, F, ...) gathered along the body axis by idx (N, R): (N, R, ...)."""
    N = x.shape[0]
    flat = x.reshape(N, x.shape[1], -1)
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))
    return out.reshape((N, idx.shape[1]) + tuple(x.shape[2:]))


def _scatter(idx, rows, F):
    """Sum of `rows` (N, R, ...) into F bodies by idx (N, R): (N, F, ...)."""
    N = rows.shape[0]
    flat = rows.reshape(N, rows.shape[1], -1)
    out = flat.new_zeros((N, F, flat.shape[-1]))
    out.scatter_add_(1, idx[..., None].expand(-1, -1, flat.shape[-1]), flat)
    return out.reshape((N, F) + tuple(rows.shape[2:]))


def _ext(R, sz, ax, dot):
    """Support extent of OBBs (R (..., 3, 3), columns = axes; half sizes
    sz (..., 3)) along world axes ax (..., A, 3): (..., A), with `dot`
    (_dot or _fdot) for the projections."""
    RT = R.transpose(-1, -2)[..., None, :, :]  # (..., 1, 3 axes, 3)
    t = [dot(ax, RT[..., q, :]).abs() * sz[..., None, q] for q in range(3)]
    return (t[0] + t[1]) + t[2]


def solve(
    spec: NeighborWorldSpec,
    pos,  # (N, F, 3) body origins (single-shape bodies: shape center)
    quat,  # (N, F, 4)
    vel,  # (N, F, 3)
    omega,  # (N, F, 3)
    size,  # (N, F, 3) shape size (sphere: [r,0,0]; box: half extents)
    inv_m,  # (N, F)
    inv_I,  # (N, F, 3, 3) world inverse inertia
    mu,  # (N, F)
    rest,  # (N, F)
    h: float,
    iters: int,
    contact_offset: float,
    slop: float,
    bounce_thresh: float,
    max_depen: float = 100.0,
):
    """Returns (vel', omega', cf (N, F, 3) normal contact force/body)."""
    dev, dt = pos.device, pos.dtype
    N, F = pos.shape[:2]
    K = spec.k_neighbors
    M = MANIFOLD
    is_box = torch.as_tensor(spec.is_box, device=dev)
    allow = torch.as_tensor(spec.allow, device=dev)
    r_sph = size[..., 0]
    # conservative bounding radius
    rb = torch.where(is_box, torch.linalg.vector_norm(size, dim=-1), r_sph)

    # ---- broadphase: K nearest admissible partners with j > i ----
    d2 = ((pos[:, :, None, :] - pos[:, None, :, :]) ** 2).sum(-1)  # (N, F, F)
    gap = torch.sqrt(d2.clamp_min(1e-12)) - rb[:, :, None] - rb[:, None, :]
    score = torch.where(allow[None], gap, BIG)
    # the K lowest scores, the lower index first among equal ones
    top_score, nidx = torch.sort(score, dim=-1, stable=True)
    top_score, nidx = top_score[..., :K], nidx[..., :K]  # (N, F, K) partner j per row i
    flat_j = nidx.reshape(N, F * K)

    def g(x):  # partner values: x (N, F, ...) -> (N, F, K, ...)
        return _take(x, flat_j).reshape((N, F, K) + tuple(x.shape[2:]))

    pj, qj, szj, rj = g(pos), g(quat), g(size), g(r_sph)
    boxj = is_box[nidx]
    pi = pos[:, :, None]
    qi = quat[:, :, None]
    szi = size[:, :, None]
    boxi = is_box[None, :, None]
    ri = r_sph[:, :, None]

    # ---- narrowphase: (N, F, K, M) point/normal(j->i)/depth ----
    # sphere-sphere
    dvec = pi - pj
    dist = torch.linalg.vector_norm(dvec, dim=-1).clamp_min(1e-9)
    n_ss = dvec / dist[..., None]
    dep_ss = (ri + rj) - dist
    pt_ss = pj + n_ss * rj[..., None]

    # sphere(i)-box(j)
    rel_ib = quat_rotate_inverse(qj, pi - pj)
    sd_ib, nl_ib, cl_ib = _point_in_box(rel_ib, szj)
    n_ib = quat_rotate(qj, nl_ib)
    dep_ib = ri - sd_ib
    pt_ib = pj + quat_rotate(qj, cl_ib)

    # box(i)-sphere(j): normal must point j -> i
    qi_k = qi.expand(qj.shape)
    rel_jb = quat_rotate_inverse(qi_k, pj - pi)
    sd_jb, nl_jb, cl_jb = _point_in_box(rel_jb, szi.expand(szj.shape))
    n_jb = -quat_rotate(qi_k, nl_jb)
    dep_jb = rj - sd_jb
    pt_jb = pi + quat_rotate(qi_k, cl_jb)

    # box-box SAT over the 6 face axes (i's, then j's) and the 9 edge-cross
    # axes (i's edge ka x j's edge kb, ka-major), in the JAX package's loop
    # order: the first axis of the largest separation wins. i's face axes
    # are one per body (not per partner), so their projections on j and on
    # d_ij are matrix products in the JAX package (_fdot), as are all the
    # other axes' projections on i.
    Ri = quat_to_matrix(qi)  # (N, F, 1, 3, 3) columns = axes
    Rj = quat_to_matrix(qj)  # (N, F, K, 3, 3)
    RiT = Ri.transpose(-1, -2)  # rows = axes
    RjT = Rj.transpose(-1, -2)
    d_ij = pj - pi  # i -> j
    edge_raw = cross(RiT[..., :, None, :], RjT[..., None, :, :]).reshape(N, F, K, 9, 3)
    edge_nrm = torch.linalg.vector_norm(edge_raw, dim=-1)
    edge_ok = edge_nrm > 1e-6  # near-parallel edges: face axes cover it
    ax_j = torch.cat([RjT, edge_raw / edge_nrm.clamp_min(1e-6)[..., None]], -2)
    dist_i = _fdot(RiT, d_ij[..., None, :])  # (N, F, K, 3)
    sep_i = dist_i.abs() - _ext(Ri, szi, RiT, _dot) - _ext(Rj, szj, RiT, _fdot)
    dist_j = _dot(ax_j, d_ij[..., None, :])  # (N, F, K, 12)
    sep_j = dist_j.abs() - _ext(Ri, szi, ax_j, _fdot) - _ext(Rj, szj, ax_j, _dot)
    sep_j = torch.cat([sep_j[..., :3], torch.where(edge_ok, sep_j[..., 3:], -BIG)], -1)
    sep = torch.cat([sep_i, sep_j], -1)  # (N, F, K, 15)
    dist_ax = torch.cat([dist_i, dist_j], -1)
    axes = torch.cat([RiT.expand(N, F, K, 3, 3), ax_j], -2)
    best = torch.argmax(sep, dim=-1, keepdim=True)  # first of the largest
    best_sep = torch.gather(sep, -1, best)[..., 0]
    best_ax = torch.gather(axes, -2, best[..., None].expand(-1, -1, -1, -1, 3))[..., 0, :]
    # orient j -> i: flip when the axis points i -> j
    best_n = best_ax * torch.where(torch.gather(dist_ax, -1, best) > 0, -1.0, 1.0)

    # manifold: 16 corner candidates, depth along the SAT axis
    # the 8 box corners made on the device (an upload would be a copy from
    # the host in every solve): corner c has the signs of the bits of c, z
    # lowest, the JAX package's order
    bits = torch.arange(8, device=dev)[:, None] >> torch.arange(2, -1, -1, device=dev)
    corners = ((bits & 1) * 2 - 1).to(dt)  # (8, 3)
    ci_w = pi[..., None, :] + quat_rotate(qi[..., None, :], corners * szi[..., None, :])
    cj_w = pj[..., None, :] + quat_rotate(qj[..., None, :], corners * szj[..., None, :])
    # corner of j beyond i's face toward j: depth = (face plane) - c.n
    bn = best_n[..., None, :]
    face_i = _fdot(pi, best_n) - _ext(Ri, szi, bn, _fdot)[..., 0]
    face_j = _dot(pj, best_n) + _ext(Rj, szj, bn, _dot)[..., 0]
    dep_cj = _fdot(cj_w, bn) - face_i[..., None]
    dep_ci = face_j[..., None] - _fdot(ci_w, bn)
    cand_dep = torch.cat([dep_cj, dep_ci], -1)  # (N, F, K, 16)
    cand_pt = torch.cat([cj_w, ci_w.expand(cj_w.shape)], -2)
    # candidates deeper than the SAT overlap are lateral artifacts: clamp
    cand_dep = torch.minimum(cand_dep, -best_sep[..., None])
    # the M deepest, the lower index first among equal depths
    top_dep, ti = torch.sort(cand_dep, dim=-1, descending=True, stable=True)
    top_dep, ti = top_dep[..., :M], ti[..., :M]  # (N, F, K, M)
    top_pt = torch.gather(cand_pt, -2, ti[..., None].expand(-1, -1, -1, -1, 3))

    # ---- select per pair-kind; slots 1..3 only used by box-box ----
    both_box = boxi & boxj
    ss = (~boxi) & (~boxj)
    ib = (~boxi) & boxj

    def pick(a_ss, a_ib, a_jb, a_bb):
        out0 = torch.where(ss[..., None], a_ss, torch.where(ib[..., None], a_ib, a_jb))
        out0 = torch.where(both_box[..., None], a_bb[..., 0, :], out0)
        rest_slots = torch.where(both_box[..., None, None], a_bb[..., 1:, :], 0.0)
        return torch.cat([out0[..., None, :], rest_slots], -2)

    point = pick(pt_ss, pt_ib, pt_jb, top_pt)  # (N, F, K, M, 3)
    normal = pick(n_ss, n_ib, n_jb, best_n[..., None, :].expand(top_pt.shape))
    dep0 = torch.where(ss, dep_ss, torch.where(ib, dep_ib, dep_jb))
    dep0 = torch.where(both_box, top_dep[..., 0], dep0)
    dep_rest = torch.where(both_box[..., None], top_dep[..., 1:], -BIG)
    depth = torch.cat([dep0[..., None], dep_rest], -1)  # (N, F, K, M)
    # a candidate row whose broadphase slot is invalid (gap >= BIG/2,
    # i.e. filtered or padding) is inert
    valid = top_score < BIG * 0.5
    depth = torch.where(valid[..., None], depth, -BIG)

    # ---- ground contacts: (N, F, 8) corner rows (spheres use slot 0) ----
    pn = torch.as_tensor(spec.plane_n, dtype=dt, device=dev)
    if spec.has_ground:
        corners_w = pos[..., None, :] + quat_rotate(quat[..., None, :], corners * size[..., None, :])
        d_gc = _fdot(corners_w, pn) - spec.plane_d  # (N, F, 8)
        gdep_box = -d_gc
        gdep_sph = r_sph - (_fdot(pos, pn) - spec.plane_d)
        gpt_sph = pos - pn * r_sph[..., None]
        if spec.ground_spheres:
            sph_g = torch.cat([gdep_sph[..., None], torch.full_like(gdep_box[..., 1:], -BIG)], -1)
        else:  # sphere-world owns sphere ground rows
            sph_g = torch.full_like(gdep_box, -BIG)
        g_dep = torch.where(is_box[None, :, None], gdep_box, sph_g)
        g_pt = torch.where(
            is_box[None, :, None, None],
            corners_w,
            torch.cat([gpt_sph[..., None, :], corners_w[..., 1:, :] * 0.0], -2),
        )
    else:
        g_dep = torch.full((N, F, 8), -BIG, dtype=dt, device=dev)
        g_pt = torch.zeros((N, F, 8, 3), dtype=dt, device=dev)

    # ---- assemble flat contact rows: F*K*M pair rows (side a is body i,
    # side b its partner), then F*8 ground rows (side b the plane) ----
    Cp, Cg = F * K * M, F * 8
    ib_ = torch.cat([nidx[..., None].expand(N, F, K, M).reshape(N, Cp),
                     torch.zeros((N, Cg), dtype=nidx.dtype, device=dev)], 1)
    has_b = torch.cat([torch.ones(Cp, dtype=torch.bool, device=dev),
                       torch.zeros(Cg, dtype=torch.bool, device=dev)])
    pt = torch.cat([point.reshape(N, Cp, 3), g_pt.reshape(N, Cg, 3)], 1)
    nrm = torch.cat([normal.reshape(N, Cp, 3), pn.expand(N, Cg, 3)], 1)
    dep = torch.cat([depth.reshape(N, Cp), g_dep.reshape(N, Cg)], 1)

    def side_a(x):
        """Per-body x (N, F, ...) on the rows' side a: (N, C, ...)."""
        rep = lambda n: x[:, :, None].expand((N, F, n) + tuple(x.shape[2:])).reshape(
            (N, F * n) + tuple(x.shape[2:]))
        return torch.cat([rep(K * M), rep(8)], 1)

    def sum_a(rows):
        """Sum of per-row values (N, C, ...) into side a's bodies (N, F, ...):
        each body's rows are contiguous, so a reshape and a sum."""
        tail = tuple(rows.shape[2:])
        return (rows[:, :Cp].reshape((N, F, K * M) + tail).sum(2)
                + rows[:, Cp:].reshape((N, F, 8) + tail).sum(2))

    mu_c = 0.5 * (side_a(mu) + torch.where(has_b, _take(mu, ib_), spec.plane_friction))
    re_c = 0.5 * (side_a(rest) + torch.where(has_b, _take(rest, ib_), spec.plane_restitution))

    active = dep > -contact_offset

    # ---- mass-split relaxed Jacobi (contacts.py math) ----
    beta = 0.2
    h_inv = 1.0 / h
    # cap matches physx.max_depenetration_velocity
    bias = torch.clamp_max(beta * h_inv * torch.clamp_min(dep - slop, 0.0), max_depen)

    af = active.to(dt)
    cnt = (sum_a(af) + _scatter(ib_, af * has_b, F)).clamp_min(1.0)
    split_a = 1.0 / side_a(cnt)
    split_b = 1.0 / _take(cnt, ib_)

    im_a = side_a(inv_m)
    im_b = torch.where(has_b, _take(inv_m, ib_), 0.0)
    iI_a = side_a(inv_I)
    iI_b = _take(inv_I, ib_) * has_b[..., None, None]
    r_a = pt - side_a(pos)
    r_b = pt - _take(pos, ib_)

    def mat_vec(I, v):  # (N, C, 3, 3) @ (N, C, 3)
        return (I * v[..., None, :]).sum(-1)

    def eff_mass(direction):
        ta = cross(r_a, direction)
        tb = cross(r_b, direction)
        ka = im_a + _dot(ta, mat_vec(iI_a, ta))
        kb = im_b + _dot(tb, mat_vec(iI_b, tb))
        return 1.0 / (ka + kb).clamp_min(1e-9)

    k_n = eff_mass(nrm)

    def rel_vel(v_, w_):
        va = side_a(v_) + cross(side_a(w_), r_a)
        vb = _take(v_, ib_) + cross(_take(w_, ib_), r_b)
        return va - torch.where(has_b[..., None], vb, 0.0)

    vn0 = _dot(rel_vel(vel, omega), nrm)
    bounce = torch.where(vn0 < -bounce_thresh, -re_c * vn0, 0.0)
    target_vn = torch.where(dep > slop, torch.maximum(bias, bounce), (dep - slop) * h_inv)

    relax = 0.8
    # the impulse's share per unit: side a +imp, side b -imp, mass-split
    wa_v, wb_v = im_a * split_a, torch.where(has_b, im_b * split_b, 0.0)
    wa_w = iI_a * split_a[..., None, None]
    wb_w = iI_b * split_b[..., None, None]

    def apply_impulse(v_, w_, imp):
        dv_b = -imp * wb_v[..., None]
        dw_b = mat_vec(wb_w, cross(r_b, -imp))
        v_ = v_ + sum_a(imp * wa_v[..., None]) + _scatter(ib_, dv_b, F)
        w_ = w_ + sum_a(mat_vec(wa_w, cross(r_a, imp))) + _scatter(ib_, dw_b, F)
        return v_, w_

    lam = torch.zeros_like(dep)
    lamt = torch.zeros_like(pt)
    for _ in range(iters):
        vr = rel_vel(vel, omega)
        vn = _dot(vr, nrm)
        new_lam = (lam + relax * k_n * (target_vn - vn)).clamp_min(0.0)
        dlam = torch.where(active, new_lam - lam, 0.0)
        imp = dlam[..., None] * nrm
        vt = vr - vn[..., None] * nrm
        vt_norm = torch.linalg.vector_norm(vt, dim=-1).clamp_min(1e-9)
        t_dir = vt / vt_norm[..., None]
        k_t = eff_mass(t_dir)
        lamt_raw = lamt - (relax * k_t * vt_norm)[..., None] * t_dir
        cap = mu_c * new_lam
        tnorm = torch.linalg.vector_norm(lamt_raw, dim=-1).clamp_min(1e-9)
        new_lamt = lamt_raw * torch.clamp_max(cap / tnorm, 1.0)[..., None]
        imp = imp + torch.where(active[..., None], new_lamt - lamt, 0.0)
        vel, omega = apply_impulse(vel, omega, imp)
        lam, lamt = new_lam, new_lamt

    f_c = torch.where(active, lam, 0.0)[..., None] * nrm * h_inv
    cf = sum_a(f_c) + _scatter(ib_, torch.where(has_b[..., None], -f_c, 0.0), F)
    return vel, omega, cf

"""FEM soft bodies: XPBD Neo-Hookean tetrahedra.

Port of test_isaacgym_tpu/physics/soft.py. The reference runs soft bodies on
the FleX backend: `<fem>` URDF links with a `.tet` mesh, Young's/Poisson/
damping materials, and the tet/tri introspection API (the reference's
examples/soft_body.py, assets/urdf/icosphere.urdf). Here:

  * state is two tensors soft_pos/soft_vel (N, Vt, 3) in SimState, batched
    over envs like everything else;
  * each substep runs `flex.num_outer_iterations x num_inner_iterations`
    Jacobi XPBD iterations. `SoftStepper.substep` has two implementations,
    picked by the tensors' device alone: CUDA tensors launch the hand-written
    kernel csrc/xpbd.cu (the prediction, every iteration, the friction and
    the damping of every env in one launch, at most XPBD_MAX_SHARED_BYTES of
    shared memory an env), CPU tensors take `_substep_torch`, a Python loop
    of eager ops with no host sync and the kernel's reference;
  * per-tet constraints follow the stable Neo-Hookean XPBD formulation
    (deviatoric C_D = ||F||_F and hydrostatic C_H = det(F) - 1 - mu/lambda,
    compliances 1/(mu V) and 1/(lambda V)), Young's/Poisson mapped to
    (mu, lambda) the standard way, so materials are a PhysParams update;
  * per-vertex accumulation is a gather through a fixed incidence table
    and a sum (no float atomics, so a step is bitwise repeatable on the
    GPU), with per-tet Jacobi under-relaxation;
  * collision is one-way: soft vertices project out of the ground plane and
    the scene's sphere, capsule, box and convex-hull shapes, with
    Coulomb-style position friction against the ground. Rigid bodies do not
    feel the soft body.

The host half (`load_tet` .. `build_soft_world`) is numpy and runs at scene
build; `SoftStepper` puts every index, mass and constant on the device once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..math.quat import cross, quat_mul, quat_rotate, quat_rotate_inverse
from ..ops import _kernels
from ..utils.trace import span

# shared memory a block of csrc/xpbd.cu may take, which holds one env's
# whole iteration state (`xpbd_shared_bytes`): the H100's opt-in maximum a
# block, 227 KB. The pedestals scene's three icospheres take 205,660 bytes.
XPBD_MAX_SHARED_BYTES = 232448


# ---------------------------------------------------------------------------
# .tet loading + derived topology
# ---------------------------------------------------------------------------
def load_tet(path: str):
    """Parse the reference's `.tet` format: `v x y z` vertex lines and
    `t i j k l` tetrahedron lines (0-based indices) — the reference's
    assets/urdf/icosphere.tet."""
    verts, tets = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "t":
                tets.append([int(x) for x in parts[1:5]])
    v = np.asarray(verts, np.float32)
    t = np.asarray(tets, np.int32)
    if len(t) == 0 or t.max() >= len(v):
        raise ValueError(f"malformed tet file {path}")
    return v, t


def surface_triangles(tets: np.ndarray):
    """(tris (S, 3), parent_tet (S,), opposite vertex (S,)): boundary faces
    (appearing in exactly one tet), wound so the normal points AWAY from the
    opposite vertex."""
    face_count = {}
    face_info = {}
    FACES = [(1, 2, 3, 0), (0, 3, 2, 1), (0, 1, 3, 2), (0, 2, 1, 3)]
    for ti, tet in enumerate(tets):
        for (a, b, c, d) in FACES:
            tri = (int(tet[a]), int(tet[b]), int(tet[c]))
            key = tuple(sorted(tri))
            face_count[key] = face_count.get(key, 0) + 1
            face_info[key] = (tri, int(tet[d]), ti)
    tris, parents, opps = [], [], []
    for key, cnt in face_count.items():
        if cnt == 1:
            tri, opp, ti = face_info[key]
            tris.append(tri)
            parents.append(ti)
            opps.append(opp)
    tris = np.asarray(tris, np.int32)
    parents = np.asarray(parents, np.int32)
    return tris, parents, np.asarray(opps, np.int32)


def _fix_winding(verts, tris, opps):
    """Flip boundary faces whose normal points toward the opposite vertex."""
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    n = np.cross(b - a, c - a)
    to_opp = verts[opps] - a
    flip = np.einsum("ij,ij->i", n, to_opp) > 0
    out = tris.copy()
    out[flip] = out[flip][:, ::-1]
    return out


def lame_params(youngs, poissons):
    """(mu, lambda) from (E, nu): numpy arrays or tensors."""
    mu = youngs / (2.0 * (1.0 + poissons))
    lam = youngs * poissons / ((1.0 + poissons) * (1.0 - 2.0 * poissons))
    return mu, lam


# ---------------------------------------------------------------------------
# world spec (host side, built at SceneBuilder.finalize)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SoftInstanceMeta:
    actor_slot: int
    name: str
    vert_start: int
    vert_count: int
    tet_start: int
    tet_count: int
    tri_start: int
    tri_count: int
    youngs: float
    poissons: float
    damping: float


@dataclasses.dataclass
class SoftWorld:
    """Static description of every soft body in one env (all envs identical).

    verts0 are env-LOCAL rest positions (actor pose composed in); tets/tris
    index the concatenated per-env vertex axis."""

    verts0: np.ndarray  # (Vt, 3)
    tets: np.ndarray  # (T, 4)
    inv_dm: np.ndarray  # (T, 3, 3)
    rest_vol: np.ndarray  # (T,)
    inv_mass: np.ndarray  # (Vt,)
    vert_tet_count: np.ndarray  # (Vt,) tets touching each vertex
    tet_jacobi_scale: np.ndarray  # (T,) 1/max vertex count over the tet's corners
    tris: np.ndarray  # (S, 3)
    tri_parent: np.ndarray  # (S,)
    inst_of_tet: np.ndarray  # (T,) instance index
    instances: List[SoftInstanceMeta]
    # rigid colliders (shape indices into Scene.shapes), one-way coupled:
    # soft verts project out of sphere/box/capsule/convex-hull shapes
    col_shape: np.ndarray  # (M,) shape indices
    col_body: np.ndarray  # (M,) env body slots
    col_kind: np.ndarray  # (M,) SHAPE_* codes
    # convex-hull planes for SHAPE_MESH colliders, padded (M, F, 4) local
    # [n, d] rows ((0,0,0,-1) padding never constrains); zeros row for
    # non-mesh colliders
    col_planes: np.ndarray
    thickness: float = 0.0  # AssetOptions.thickness collision margin

    @property
    def num_verts(self):
        return len(self.verts0)

    @property
    def num_tets(self):
        return len(self.tets)


def build_soft_world(
    protos, actors, scene_shapes, env0_origin, hulls=None
) -> Optional[SoftWorld]:
    """Collect `<fem>` links of env-0's actors into one SoftWorld.

    Called from SceneBuilder.finalize; `protos` are env-0 _ProtoActor rows
    (all envs share the layout; per-env pose differences beyond the env
    origin are not supported for soft bodies)."""
    from ..assets.types import _quat_mul_np, _rot_np, zero_config_link_pose

    v_all, t_all, inst_meta, inst_of_tet = [], [], [], []
    tris_all, parents_all = [], []
    inv_m_all = []
    v_ofs = 0
    t_ofs = 0
    s_ofs = 0
    thickness = 0.0
    for slot, p in enumerate(protos):
        for li, link in enumerate(p.asset.links):
            fem = getattr(link, "fem", None)
            if fem is None:
                continue
            # soft body rest pose: actor pose ∘ zero-config link pose ∘ fem origin
            lp, lq = zero_config_link_pose(p.asset, li)
            fp = lp + _rot_np(lq, np.asarray(fem.origin_pos))
            fq = _quat_mul_np(lq, np.asarray(fem.origin_quat))
            wp = p.pos + _rot_np(p.quat, fp)
            wq = _quat_mul_np(p.quat, fq)
            verts = (
                _rot_np_batch(wq, fem.verts) + np.asarray(wp)[None]
            ).astype(np.float32)
            tets = fem.tets + v_ofs
            tris, parents, opps = surface_triangles(fem.tets)
            tris = _fix_winding(fem.verts, tris, opps)
            # per-vertex mass from tet rest volumes
            d0 = fem.verts[fem.tets[:, 1]] - fem.verts[fem.tets[:, 0]]
            d1 = fem.verts[fem.tets[:, 2]] - fem.verts[fem.tets[:, 0]]
            d2 = fem.verts[fem.tets[:, 3]] - fem.verts[fem.tets[:, 0]]
            vol = np.abs(np.einsum("ij,ij->i", np.cross(d0, d1), d2)) / 6.0
            m = np.zeros(len(fem.verts))
            for k in range(4):
                np.add.at(m, fem.tets[:, k], fem.density * vol / 4.0)
            inv_m_all.append(1.0 / np.clip(m, 1e-9, None))
            v_all.append(verts)
            t_all.append(tets)
            tris_all.append(tris + v_ofs)
            parents_all.append(parents + t_ofs)
            inst_of_tet.append(np.full(len(tets), len(inst_meta), np.int32))
            inst_meta.append(
                SoftInstanceMeta(
                    actor_slot=slot,
                    name=link.name,
                    vert_start=v_ofs,
                    vert_count=len(verts),
                    tet_start=t_ofs,
                    tet_count=len(tets),
                    tri_start=s_ofs,
                    tri_count=len(tris),
                    youngs=fem.youngs,
                    poissons=fem.poissons,
                    damping=fem.damping,
                )
            )
            v_ofs += len(verts)
            t_ofs += len(tets)
            s_ofs += len(tris)
            thickness = max(thickness, getattr(p.asset, "thickness", 0.0))
    if not inst_meta:
        return None

    verts0 = np.concatenate(v_all, 0)
    tets = np.concatenate(t_all, 0)
    # rest-shape matrices in the DEFORMED-space env frame
    d0 = verts0[tets[:, 1]] - verts0[tets[:, 0]]
    d1 = verts0[tets[:, 2]] - verts0[tets[:, 0]]
    d2 = verts0[tets[:, 3]] - verts0[tets[:, 0]]
    Dm = np.stack([d0, d1, d2], axis=-1)  # (T, 3, 3) columns
    rest_vol = np.abs(np.linalg.det(Dm)) / 6.0
    inv_dm = np.linalg.inv(Dm)
    vt_count = np.zeros(len(verts0))
    for k in range(4):
        np.add.at(vt_count, tets[:, k], 1.0)
    # consistent Jacobi under-relaxation: scale each tet's Δλ by 1/(max
    # count over its 4 verts) so the per-VERTEX aggregate correction stays
    # bounded while λ accumulation matches the applied positions (dividing
    # positions by count but accumulating the FULL Δλ diverges — λ winds up
    # against corrections that never happened)
    jac = 1.0 / np.maximum.reduce([vt_count[tets[:, k]] for k in range(4)])

    # rigid colliders: every sphere/box/capsule/hull shape in the env
    # (SHAPE_* codes per core/scene.py)
    kind_arr = np.asarray(scene_shapes.kind)
    col = np.nonzero(np.isin(kind_arr, (0, 1, 2, 3)))[0]
    # mesh shapes without a usable hull can't be projected — drop them
    hull_ids = (
        np.asarray(scene_shapes.hull_id)
        if scene_shapes.hull_id is not None
        else np.full(len(kind_arr), -1)
    )
    keep = [
        s
        for s in col
        if kind_arr[s] != 3
        or (hulls is not None and hull_ids[s] >= 0 and len(hulls[hull_ids[s]]) >= 4)
    ]
    col = np.asarray(keep, np.int64)
    plane_sets = []
    for s in col:
        if kind_arr[s] == 3:
            from .contacts import _hull_planes

            plane_sets.append(_hull_planes(np.asarray(hulls[hull_ids[s]])))
        else:
            plane_sets.append(np.zeros((0, 4), np.float32))
    F = max([len(pl) for pl in plane_sets], default=1) or 1
    planes = np.zeros((len(col), F, 4), np.float32)
    planes[..., 3] = -1.0  # pad: 0.x - 1 <= 0 never constrains
    for k, pl in enumerate(plane_sets):
        planes[k, : len(pl)] = pl
    return SoftWorld(
        verts0=verts0,
        tets=tets,
        inv_dm=inv_dm.astype(np.float32),
        rest_vol=rest_vol.astype(np.float32),
        inv_mass=np.concatenate(inv_m_all).astype(np.float32),
        vert_tet_count=np.clip(vt_count, 1.0, None).astype(np.float32),
        tet_jacobi_scale=jac.astype(np.float32),
        tris=np.concatenate(tris_all, 0),
        tri_parent=np.concatenate(parents_all, 0),
        inst_of_tet=np.concatenate(inst_of_tet),
        instances=inst_meta,
        col_shape=col.astype(np.int32),
        col_body=np.asarray(scene_shapes.body_slot)[col].astype(np.int32),
        col_kind=kind_arr[col].astype(np.int32),
        col_planes=planes,
        thickness=float(thickness),
    )


def incidence(tets: np.ndarray, num_verts: int, copies: int = 1) -> np.ndarray:
    """(Vt, K) int64: for each vertex, the flat indices of its per-corner
    contributions in a (copies, T, 4) layout flattened, ordered by (copy,
    corner, tet) as a scatter-add of corner 0's rows, then corner 1's, ...
    applies them; padded with copies * T * 4, the index of an appended zero
    row."""
    T = len(tets)
    lists = [[] for _ in range(num_verts)]
    for c in range(copies):
        for k in range(4):
            for t in range(T):
                lists[int(tets[t, k])].append(c * 4 * T + 4 * t + k)
    K = max(len(x) for x in lists)
    out = np.full((num_verts, K), copies * 4 * T, np.int64)
    for v, x in enumerate(lists):
        out[v, : len(x)] = x
    return out


def xpbd_shared_bytes(num_verts: int, num_tets: int, num_colliders: int) -> int:
    """Shared memory a block of csrc/xpbd.cu takes (its xpbd_shared_bytes):
    positions 3V, both multipliers, both compliances and gamma 5T, every
    (constraint, corner) correction 24T, each collider's pose and size 10M
    floats."""
    return 4 * (3 * num_verts + 29 * num_tets + 10 * num_colliders)


class XpbdTables(NamedTuple):
    """The per-mesh tables csrc/xpbd.cu reads, which every env shares."""

    tets: torch.Tensor  # (T, 4) int32
    inv_dm: torch.Tensor  # (T, 9) f32: Dm^-1 row-major
    w4: torch.Tensor  # (T, 4) f32: the corners' inverse masses
    jac: torch.Tensor  # (T,) f32: the relaxed Jacobi scale
    inc_start: torch.Tensor  # (V + 1,) int32: each vertex's entries in inc_slot
    inc_slot: torch.Tensor  # (4T,) int32: k * 3T + t of each (tet t, corner k), by (k, t)
    vert_order: torch.Tensor  # (V,) int32: the vertices by descending valence
    vert_inst: torch.Tensor  # (V,) int32: the instance of the vertex's tets, -1 for none
    col: torch.Tensor  # (M, 3) int32: body slot, shape slot, SHAPE_* kind
    col_quat: torch.Tensor  # (M, 4) f32: the shape's rotation in its body
    planes: torch.Tensor  # (M, F, 8) f32: a hull's [n, d, margin |n|, |n|^2 clipped, 0, 0]


# ---------------------------------------------------------------------------
# the XPBD substep
# ---------------------------------------------------------------------------
class _Consts(NamedTuple):
    """What every iteration of a substep reads: the compliances over h^2
    and the hydrostatic offset (N, T), the zero row the per-vertex gather
    pads with (N, 1, 3), and the colliders' poses and sizes."""

    alpha_d: torch.Tensor
    alpha_h: torch.Tensor
    gamma: torch.Tensor
    zero_row: torch.Tensor
    colliders: Optional[tuple]


class _Collider:
    """One rigid collider's constants on the device."""

    def __init__(self, mi: int, kind: int, planes: np.ndarray, margin: float, dev):
        self.mi = mi
        self.kind = kind
        if kind == 3:
            n = planes[:, :3]
            # [n, |n|^2 clipped] per face: the hit face's row in one gather
            nn = np.clip(np.sum(n * n, -1), 1e-9, None)
            self.n_t = torch.as_tensor(n.T.copy(), device=dev)  # (3, F)
            self.d = torch.as_tensor(planes[:, 3].copy(), device=dev)  # (F,)
            self.margin_n = torch.as_tensor(
                (np.float32(margin) * np.sqrt(np.sum(n * n, -1))).astype(np.float32), device=dev)
            self.rows = torch.as_tensor(
                np.concatenate([n, nn[:, None]], 1).astype(np.float32), device=dev)  # (F, 4)


class SoftStepper:
    """Device-side soft solve bound to one SoftWorld (static topology)."""

    def __init__(self, world: SoftWorld, scene, device="cuda"):
        self.world = world
        self.scene = scene
        dev = self.device = torch.device(device)
        fx = scene.sim_params.flex
        # outer x inner mirrors the FleX iteration budget directly
        # (the reference's soft_body.py: 4 x 20); averaged Jacobi needs the
        # full count
        self.iters = max(1, fx.num_outer_iterations) * max(1, fx.num_inner_iterations)
        self.relax = float(fx.relaxation)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def index(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        self.friction = 0.5
        self.has_ground = scene.ground is not None
        n, self.plane_d = np.array([0.0, 0.0, 1.0]), 0.0
        if self.has_ground:
            n = np.asarray(scene.ground.normal, np.float64)
            n = n / max(np.linalg.norm(n), 1e-9)
            self.plane_d = float(scene.ground.distance)
            self.friction = float(scene.ground.static_friction)
        self.plane_n = f32(n)
        self.plane_n_host = tuple(float(c) for c in np.asarray(n, np.float32))
        self.margin = float(world.thickness)

        w = world
        T, V = w.num_tets, w.num_verts
        self.tets = index(w.tets)  # (T, 4)
        self.tets_flat = self.tets.reshape(-1)
        self.inv_dm = f32(w.inv_dm)  # (T, 3, 3)
        self.inv_dm_t = f32(np.swapaxes(w.inv_dm, -1, -2))
        self.rest_vol = f32(w.rest_vol)
        self.inst = index(w.inst_of_tet)
        # corner inverse masses (T, 4, 1) and the relaxed Jacobi scale (T,)
        self.w4 = f32(w.inv_mass[w.tets])[..., None]
        self.jac_scale = f32(w.tet_jacobi_scale) * self.relax
        # per-vertex gathers replacing the scatters: the deviatoric then the
        # hydrostatic contributions (N, 2*4*T + 1, 3); each tet's damping
        # repeated on its corners (N, 4*T + 1)
        self.gather_dx = index(incidence(w.tets, V, copies=2).reshape(-1))
        corner_incidence = incidence(w.tets, V, copies=1)
        self.gather_corner = index(corner_incidence)
        self.tris = index(w.tris)
        self.axes = torch.arange(3, device=dev)
        # colliders: constants and shape rotations on the device
        self.col_body = index(w.col_body)
        self.col_shape = index(w.col_shape)
        self.col_quat = f32(np.asarray(scene.shapes.quat, np.float32)[w.col_shape])
        self.colliders = [
            _Collider(mi, int(k), w.col_planes[mi], self.margin, dev)
            for mi, k in enumerate(w.col_kind)
        ]
        self.xpbd = self._xpbd_tables(corner_incidence)

    def _xpbd_tables(self, corner_incidence: np.ndarray) -> XpbdTables:
        """csrc/xpbd.cu's tables from this stepper's own constants: each
        vertex's (tet, corner) contributions in the order of the plain
        version's gather (`incidence`), kept once for both constraints."""
        w, dev = self.world, self.device
        T, V = w.num_tets, w.num_verts
        live = corner_incidence < 4 * T
        slots = (corner_incidence % 4) * 3 * T + corner_incidence // 4
        counts = live.sum(1)
        vert_inst = np.full(V, -1, np.int64)
        for k in range(4):
            vert_inst[w.tets[:, k]] = w.inst_of_tet
        planes = torch.zeros((len(self.colliders), w.col_planes.shape[1], 8),
                             dtype=torch.float32, device=dev)
        for c in self.colliders:
            if c.kind == 3:
                planes[c.mi, :, :3] = c.n_t.T
                planes[c.mi, :, 3] = c.d
                planes[c.mi, :, 4] = c.margin_n
                planes[c.mi, :, 5] = c.rows[:, 3]

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        return XpbdTables(
            tets=i32(w.tets),
            inv_dm=self.inv_dm.reshape(T, 9).contiguous(),
            w4=self.w4[..., 0].contiguous(),
            jac=self.jac_scale.contiguous(),
            inc_start=i32(np.concatenate([[0], np.cumsum(counts)])),
            inc_slot=i32(slots[live]),
            vert_order=i32(np.argsort(-counts, kind="stable")),
            vert_inst=i32(vert_inst),
            col=i32(np.stack([w.col_body, w.col_shape, w.col_kind], -1).reshape(-1, 3)),
            col_quat=self.col_quat.reshape(-1, 4).contiguous(),
            planes=planes,
        )

    # ------------------------------------------------------------------
    def materials(self, params, h):
        """(alpha_d, alpha_h, gamma) per (env, tet): the compliances over h^2
        and the hydrostatic rest offset."""
        E = params.soft_youngs[:, self.inst]  # (N, T)
        nu = params.soft_poissons[:, self.inst]
        mu, lam = lame_params(E, nu)
        vol = self.rest_vol[None]
        alpha_d = 1.0 / torch.clamp(mu * vol, min=1e-12) / (h * h)
        alpha_h = 1.0 / torch.clamp(lam * vol, min=1e-12) / (h * h)
        gamma = 1.0 + mu / torch.clamp(lam, min=1e-12)
        return alpha_d, alpha_h, gamma

    def collider_poses(self, body_pos, body_quat, params):
        """(positions (N, M, 3), rotations (N, M, 4), sizes (N, M, 3)) of the
        colliders this substep, from the body poses it is given."""
        bq = body_quat[:, self.col_body]
        cp = body_pos[:, self.col_body] + quat_rotate(bq, params.shape_pos[:, self.col_shape])
        cq = quat_mul(bq, self.col_quat.expand(bq.shape))
        return cp, cq, params.shape_size[:, self.col_shape]

    def prepare(self, soft_pos, soft_vel, body_pos, body_quat, params, h, gravity):
        """(predicted positions (N, Vt, 3), the iterations' constants, zero
        λ_D and λ_H (N, T)) of a substep."""
        N, T = soft_pos.shape[0], self.world.num_tets
        alpha_d, alpha_h, gamma = self.materials(params, h)
        v = soft_vel + h * gravity
        p = soft_pos + h * v
        colliders = None
        if self.colliders:
            colliders = self.collider_poses(body_pos, body_quat, params)
        zero_row = torch.zeros((N, 1, 3), dtype=p.dtype, device=p.device)
        lam = torch.zeros((N, T), dtype=p.dtype, device=p.device)
        return p, _Consts(alpha_d, alpha_h, gamma, zero_row, colliders), lam, lam

    def substep(self, soft_pos, soft_vel, body_pos, body_quat, params, h, gravity):
        """One XPBD substep: returns (pos', vel'). CPU tensors take the plain
        version; CUDA tensors launch csrc/xpbd.cu."""
        args = (soft_pos, soft_vel, body_pos, body_quat, params, h, gravity)
        if soft_pos.device.type == "cpu":
            return self._substep_torch(*args)
        return self._substep_cuda(*args)

    def _substep_torch(self, soft_pos, soft_vel, body_pos, body_quat, params, h, gravity):
        """`substep`'s plain version: the loop of `iterate` in eager ops."""
        N, T = soft_pos.shape[0], self.world.num_tets
        p, consts, lam_d, lam_h = self.prepare(soft_pos, soft_vel, body_pos, body_quat,
                                               params, h, gravity)
        with span("soft.iterations"):
            for _ in range(self.iters):
                p, lam_d, lam_h = self.iterate(p, lam_d, lam_h, consts)

        # Coulomb-style position friction, ONCE per substep: ground-contact
        # verts lose tangential motion up to mu * (normal correction)
        if self.has_ground:
            pn = self.plane_n
            d0 = soft_pos @ pn - self.plane_d - self.margin
            # normal correction this substep ~ how far the vert would have
            # sunk: approach distance clipped at 0
            appr = torch.clamp(-(d0 + h * (soft_vel @ pn)), min=0.0)
            mot = p - soft_pos
            tan = mot - (mot @ pn)[..., None] * pn
            tn = torch.clamp(_norm(tan), min=1e-9)
            keep = torch.clamp(1.0 - self.friction * appr / tn, 0.0, 1.0)
            p = p - torch.where((appr > 0)[..., None], (1.0 - keep[..., None]) * tan, 0.0)

        v_new = (p - soft_pos) / h
        # per-instance damping mapped to verts through the tets: the max
        # over a vertex's tets (0 where none is larger)
        dmp = params.soft_damping[:, self.inst]  # (N, T)
        corners = torch.cat([dmp[..., None].expand(N, T, 4).reshape(N, 4 * T),
                             torch.zeros_like(dmp[:, :1])], 1)
        damp_v = torch.clamp(corners[:, self.gather_corner].amax(-1), min=0.0)
        v_new = v_new * torch.clamp(1.0 - damp_v[..., None], 0.0, 1.0)
        return p, v_new

    def _substep_cuda(self, soft_pos, soft_vel, body_pos, body_quat, params, h, gravity):
        """One launch of csrc/xpbd.cu on the current stream for float32 CUDA
        tensors; raises on anything else. The compliances come from
        `materials`, in eager ops, as in the plain version."""
        w, x = self.world, self.xpbd
        V, T, M = w.num_verts, w.num_tets, len(self.colliders)
        need = xpbd_shared_bytes(V, T, M)
        if need > XPBD_MAX_SHARED_BYTES:
            raise ValueError(
                f"xpbd kernel: {V} vertices, {T} tets and {M} colliders an env need {need} "
                f"bytes of shared memory, more than its XPBD_MAX_SHARED_BYTES = "
                f"{XPBD_MAX_SHARED_BYTES}")
        dev, N = soft_pos.device, soft_pos.shape[0]
        alpha_d, alpha_h, gamma = self.materials(params, h)
        I = params.soft_damping.shape[-1]
        B, S = body_pos.shape[1], params.shape_pos.shape[1]
        # the checked inputs, contiguous, alive until the launch is queued
        (soft_pos, soft_vel, body_pos, body_quat, shape_pos, shape_size, damping, gravity,
         alpha_d, alpha_h, gamma) = _kernels.inputs("xpbd", dev, (
            ("soft_pos", soft_pos, (N, V, 3)), ("soft_vel", soft_vel, (N, V, 3)),
            ("body_pos", body_pos, (N, B, 3)), ("body_quat", body_quat, (N, B, 4)),
            ("shape_pos", params.shape_pos, (N, S, 3)), ("shape_size", params.shape_size, (N, S, 3)),
            ("soft_damping", params.soft_damping, (N, I)), ("gravity", gravity, (3,)),
            ("alpha_d", alpha_d, (N, T)), ("alpha_h", alpha_h, (N, T)), ("gamma", gamma, (N, T)),
        ))
        if x.tets.device != dev:
            raise ValueError(f"xpbd kernel: the mesh's tables lie on {x.tets.device}, not {dev}")
        out_pos, out_vel = torch.empty((2, N, V, 3), dtype=torch.float32, device=dev).unbind(0)
        if N == 0:  # no env: nothing to launch
            return out_pos, out_vel
        fn = _launch_entry()
        nx, ny, nz = self.plane_n_host
        with span("soft.iterations"):
            _kernels.launch(
                "xpbd", fn, dev,
                *(t.data_ptr() for t in x), V, T, M, x.planes.shape[1],
                soft_pos.data_ptr(), soft_vel.data_ptr(), alpha_d.data_ptr(), alpha_h.data_ptr(),
                gamma.data_ptr(), damping.data_ptr(), I,
                body_pos.data_ptr(), body_quat.data_ptr(), B,
                shape_pos.data_ptr(), shape_size.data_ptr(), S,
                gravity.data_ptr(), out_pos.data_ptr(), out_vel.data_ptr(), N,
                self.iters, int(self.has_ground), h, nx, ny, nz, self.plane_d, self.margin,
                self.friction,
            )
        return out_pos, out_vel

    def iterate(self, p, lam_d, lam_h, c: _Consts):
        """One Jacobi XPBD iteration: both tet constraints from the same
        positions, their corrections summed per vertex, then the ground and
        the colliders."""
        N, T = lam_d.shape
        x = p.index_select(1, self.tets_flat).view(N, T, 4, 3)
        # F^T: row j of Ds^T is x_{j+1} - x_0, so F^T = inv_dm^T Ds^T, and
        # the gradients come out as rows: G^T = inv_dm (dC/dF)^T
        ft = _mm(self.inv_dm_t, x[:, :, 1:] - x[:, :, :1])  # (N, T, 3, 3)

        # deviatoric: C = ||F||_F (UN-shifted — the Macklin/Müller stable
        # Neo-Hookean pairing: this rest tension is what cancels the -mu/lam
        # offset inside gamma at F=I); dC/dF = F / ||F||_F
        fn = torch.sqrt(torch.clamp((ft * ft).sum((-2, -1)), min=1e-12))
        g4 = _with_corner0(_mm(self.inv_dm, ft / fn[..., None, None]))
        dl = self._delta(g4, fn, c.alpha_d, lam_d)
        lam_d = lam_d + dl

        # hydrostatic: C = det(F) - gamma; dC/dF = cof(F), whose columns are
        # crosses of F's columns (the rows of F^T); det(F) is their triple
        # product
        cof_t = cross(torch.roll(ft, -1, -2), torch.roll(ft, -2, -2))
        det = (ft[:, :, 0] * cof_t[:, :, 0]).sum(-1)
        gh4 = _with_corner0(_mm(self.inv_dm, cof_t))
        dlh = self._delta(gh4, det - c.gamma, c.alpha_h, lam_h)
        lam_h = lam_h + dlh

        contrib = torch.cat([self._corrections(g4, dl), self._corrections(gh4, dlh),
                             c.zero_row], 1)
        V = p.shape[1]
        p = p + contrib.index_select(1, self.gather_dx).view(N, V, -1, 3).sum(-2)
        return self.collide(p, c.colliders), lam_d, lam_h

    def collide(self, p, colliders):
        """Project the vertices out of the ground, then out of each collider
        in collider order: position projection against infinite-mass
        colliders, idempotent per iteration (friction applies ONCE after the
        loop: a per-iteration friction subtraction multiplies the tangential
        correction by the iteration count and pumps energy)."""
        margin = self.margin
        if self.has_ground:
            pn = self.plane_n
            d = p @ pn - self.plane_d - margin
            p = p - torch.clamp(d, max=0.0)[..., None] * pn
        if colliders is not None:
            cp_all, cq_all, csz_all = colliders
            for c in self.colliders:
                m = slice(c.mi, c.mi + 1)
                p = self._collide(c, p, cp_all[:, m], cq_all[:, m], csz_all[:, m], margin)
        return p

    def _delta(self, g4, C, alpha, lam):
        """A constraint's relaxed Δλ (N, T) from its value C, compliance
        alpha and accumulated λ, and its corners' gradients g4 (N, T, 4, 3)."""
        wsum = ((g4 * g4).sum(-1) * self.w4[..., 0]).sum(-1)
        dl = -(C + alpha * lam) / torch.clamp(wsum + alpha, min=1e-9)
        return dl * self.jac_scale

    def _corrections(self, g4, dl):
        """A constraint's position corrections of each (tet, corner), (N, 4T, 3)."""
        N, T = dl.shape
        return (self.w4 * g4 * dl[..., None, None]).reshape(N, 4 * T, 3)

    def _collide(self, c: _Collider, p, cp, cq, csz, margin):
        """p with the vertices inside collider c (pose cp, cq and size csz,
        each (N, 1, ...)) moved onto its surface grown by `margin`."""
        if c.kind == 0:  # sphere
            rel = p - cp
            r = csz[..., 0] + margin
            d = torch.clamp(_norm(rel), min=1e-9)
            p_out = cp + rel / d[..., None] * r[..., None]
            return torch.where((d < r)[..., None], p_out, p)
        rel = quat_rotate_inverse(cq, p - cp)
        if c.kind == 2:  # capsule: segment along local z
            r = csz[..., 0] + margin
            hl = csz[..., 1]
            zc = torch.minimum(torch.maximum(rel[..., 2], -hl), hl)
            seg = torch.stack([torch.zeros_like(zc), torch.zeros_like(zc), zc], -1)
            off = rel - seg
            d = torch.clamp(_norm(off), min=1e-9)
            inside = d < r
            rel_fixed = seg + off / d[..., None] * r[..., None]
        elif c.kind == 3:  # convex hull: push out of the max plane
            dd = rel @ c.n_t + c.d - c.margin_n  # (N, V, F)
            dmax, fi = torch.max(dd, -1)
            inside = dmax < 0
            hit = c.rows[fi]  # (N, V, 4): the face's normal and |n|^2
            rel_fixed = rel - (dmax / hit[..., 3])[..., None] * hit[..., :3]
        else:  # box
            half = (csz + margin).expand(rel.shape)
            q = rel.abs() - half
            inside = (q < 0).all(-1)
            ax = torch.argmax(q, -1, keepdim=True)
            tgt = torch.sign(rel.gather(-1, ax)) * half.gather(-1, ax)
            rel_fixed = torch.where(self.axes == ax, tgt, rel)
        p_out = cp + quat_rotate(cq, rel_fixed)
        return torch.where(inside[..., None], p_out, p)

    # -- introspection ------------------------------------------------------
    def deformation(self, soft_pos):
        """F^T (N, T, 3, 3) of every tet."""
        x = soft_pos[:, self.tets]
        return _mm(self.inv_dm_t, x[:, :, 1:] - x[:, :, :1])

    def tet_stress(self, soft_pos, params):
        """Per-tet Cauchy stress (N, T, 3, 3) from the Neo-Hookean model:
        sigma = mu/J (F F^T - I) + lambda (J - 1) I — the quantity behind
        get_sim_tetrahedra's tet_stress and the Von-Mises stress viz."""
        E = params.soft_youngs[:, self.inst]
        nu = params.soft_poissons[:, self.inst]
        mu, lam = lame_params(E, nu)
        ft = self.deformation(soft_pos)
        J = torch.clamp(_det_rows(ft), min=1e-6)
        B = ft.transpose(-1, -2) @ ft  # F F^T
        I3 = torch.eye(3, dtype=ft.dtype, device=ft.device)
        return (mu / J)[..., None, None] * (B - I3) + (lam * (J - 1.0))[..., None, None] * I3

    def tri_normals(self, soft_pos):
        """(N, S, 3) outward unit normals of the surface triangles."""
        t = self.tris
        a, b, c = soft_pos[:, t[:, 0]], soft_pos[:, t[:, 1]], soft_pos[:, t[:, 2]]
        n = cross(b - a, c - a)
        return n / torch.clamp(_norm(n, keepdim=True), min=1e-9)


# ---------------------------------------------------------------------------
# the hand-written kernel's library (csrc/xpbd.cu)
# ---------------------------------------------------------------------------
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (
    [_P] * 11 + [_I] * 4  # the mesh's tables, V T M F
    + [_P] * 6 + [_I]  # soft_pos soft_vel alpha_d alpha_h gamma damping, I
    + [_P] * 2 + [_I] + [_P] * 2 + [_I]  # body_pos body_quat B shape_pos shape_size S
    + [_P] * 3 + [_I] * 3  # gravity pos_out vel_out, N iters has_ground
    + [_F] * 7 + [_P]  # h nx ny nz plane_d margin friction, stream
)


@functools.cache
def _launch_entry():
    """xpbd_launch, once the library's shared-memory layout was checked
    against xpbd_shared_bytes."""
    sized = _kernels.entry("xpbd", "xpbd_shared_bytes", [_I] * 3, ctypes.c_longlong)
    if sized(195, 570, 1) != xpbd_shared_bytes(195, 570, 1):
        raise RuntimeError("csrc/xpbd.cu's shared-memory layout differs from xpbd_shared_bytes")
    return _kernels.entry("xpbd", "xpbd_launch", _ARGTYPES)


def _norm(x, keepdim=False):
    """jnp.linalg.norm over the last axis: sqrt of the sum of squares."""
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def _mm(a, b):
    """a @ b over the last two axes of 3 x 3 matrices, broadcasting, as a
    product and a sum (a batched gemm of 3 x 3 blocks is slower on both
    devices)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _with_corner0(g):
    """(N, T, 4, 3) gradients of all four corners from those of corners 1-3
    as rows (N, T, 3, 3): corner 0's is minus their sum."""
    return torch.cat([-g.sum(-2, keepdim=True), g], -2)


def _det_rows(m):
    """det of (..., 3, 3) matrices as the triple product of their rows."""
    return (m[..., 0, :] * cross(m[..., 1, :], m[..., 2, :])).sum(-1)


def _rot_np_batch(q, v):
    """Rotate (V, 3) numpy vectors by one xyzw quaternion."""
    qv, qw = np.asarray(q[:3]), float(q[3])
    t = 2.0 * np.cross(np.broadcast_to(qv, v.shape), v)
    return np.asarray(v) + qw * t + np.cross(np.broadcast_to(qv, v.shape), t)

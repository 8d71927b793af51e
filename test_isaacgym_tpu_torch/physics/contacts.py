"""Contact generation and batched impulse solver (free bodies AND
articulation links, two-way).

Port of test_isaacgym_tpu/physics/contacts.py:
  * `ContactSolver.__init__` builds the same collidable entities, fast-path
    specs and static candidate-contact row table as the JAX package, and
    every index, one-hot and per-row constant that narrowphase and the solve
    read, as tensors on the device, once;
  * `ContactSolver.narrowphase` computes (point, normal, depth, active) of
    every row of kinds 0-16: sphere, capsule and box against the ground
    plane or the heightfield; sphere-sphere, sphere-box, sphere-capsule,
    capsule-capsule, capsule-box; the box-box face-SAT manifold and the
    deepest edge-edge pair; and the convex-hull kinds, each a manifold of
    the 4 deepest candidates of a shape pair (hull vertices against the
    ground, a box or another hull; box corners in a hull) or a sphere or
    capsule end against a hull's face planes; and the SDF probe rows of
    kind 17 (`_sdf_narrowphase`): a mesh's surface probes pushed through
    the other mesh's signed-distance field, a voxel grid read by trilinear
    interpolation (`_sdf_trilinear`) or a closed form differentiated by
    autograd, 16 rows a pair direction;
  * `ContactSolver.solve` runs the dense sphere-world fast path
    (ops/sphere_world.py), the neighbor-list solve of large mixed
    box/sphere worlds (ops/neighbor_world.py), then the relaxed-Jacobi
    solve of the table over FREE, LINK and STATIC sides with cross-step
    warm start.

Each contact side is one of
  FREE   — free rigid body: responds via (1/m, I^-1) impulses,
  LINK   — articulation link: responds via joint-space impulses
           dqd = A^-1 Jp^T lam, where A = M + h*D is the same implicit
           operator the drive solve factorizes (so contact feels the
           drive's implicit damping),
  STATIC — world geometry: kinematic, no response.

Form of the solve. The JAX package keeps per-contact state in component
form (tuples of (N, C) arrays, scalar loops over the link dofs), a TPU
layout choice. Here it is in vector form, which keeps the eager op count
of a Jacobi iteration independent of the number of link dofs: every side
that responds is an "entity" (a free body, or one copy of an articulation
group) whose generalized velocity is one row of u (N, E + 1, Dmax) — a free
body's row is [v, w], a copy's row is its qd — and each contact side has a
(3, Dmax) Jacobian J from its entity's row to the velocity of the contact
point, and W = split * M^-1 J^T back. A Jacobi sweep is then a gather of
u, one batched product with [J_a, -J_b], the per-contact update, one
product with [W_a; -W_b] and one one-hot matmul that sums the rows'
impulses into u (full f32; tf32 would round the impulses). Only the order
of summation differs from the JAX package.

Collision group/filter semantics match create_actor(group, filter):
same group (or group -1) collides; shared filter bit suppresses
(the reference's examples/1080_balls_of_solitude.py:117-138).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..core.scene import (
    SHAPE_BOX,
    SHAPE_CAPSULE,
    SHAPE_MESH,
    SHAPE_SPHERE,
    Scene,
)
from ..math.quat import cross, quat_conjugate, quat_mul, quat_rotate, quat_to_matrix
from ..math.spatial import skew
from ..utils import debug as _debug
from ..utils.linalg import spd_inv

_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    dtype=np.float32,
)

# side types
T_FREE, T_LINK, T_STATIC = 0, 1, 2

# dispatch codes
K_SPH_PLANE, K_CAP_PLANE, K_BOX_PLANE = 0, 1, 2
K_SPH_SPH, K_SPH_BOX, K_SPH_CAP, K_CAP_CAP, K_CAP_BOX, K_BOX_BOX = 3, 4, 5, 6, 7, 8
K_BOX_BOX_EDGE = 9
# convex-hull kinds (mesh shapes with a hull; VHACD pieces are hulls too)
K_HULL_PLANE = 10  # 4 deepest hull verts vs ground/heightfield
K_HULLV_BOX = 11  # 4 deepest hull(a) verts in box(b)
K_BOXV_HULL = 12  # 4 deepest box(b) corners in hull(a)
K_HULLV_HULL = 13  # 4 deepest hull(a) verts in hull(b)
K_HULLV_HULL_R = 14  # 4 deepest hull(b) verts in hull(a)
K_SPH_HULL = 15  # sphere(a) vs hull(b)
K_CAP_HULL = 16  # capsule(a) endpoint spheres vs hull(b)
K_PT_SDF = 17  # surface probes of mesh(a) vs voxel SDF of mesh(b)
# the kinds this package's narrowphase computes, in the JAX package's order
NARROWPHASE_KINDS = tuple(range(K_PT_SDF + 1))
# kinds whose shape pair emits _MANIFOLD consecutive rows, computed once a pair
_HULL_MANIFOLD_KINDS = (K_HULL_PLANE, K_HULLV_BOX, K_BOXV_HULL, K_HULLV_HULL, K_HULLV_HULL_R)

_MANIFOLD = 4  # contact manifold size for hull vertex kinds
_SDF_MANIFOLD = 16  # manifold size for SDF probe kinds
# rows a pair emits, of the kinds that compute a pair's rows at once
_ROWS_OF_PAIR = {**{k: _MANIFOLD for k in _HULL_MANIFOLD_KINDS}, K_PT_SDF: _SDF_MANIFOLD}

# most shape pairs the static contact table takes by default (the JAX
# package's default `max_pair_shapes`)
MAX_PAIR_SHAPES = 4096
# relaxation of the Jacobi update (contacts.py:1629 of the JAX package)
RELAX = 0.8


class _Side(NamedTuple):
    """Static per-contact side descriptors (numpy, length C)."""

    type: np.ndarray  # T_FREE / T_LINK / T_STATIC
    free: np.ndarray  # free-body index (safe 0)
    group: np.ndarray  # articulation group id (safe 0)
    copy: np.ndarray  # copy within group (safe 0)
    link: np.ndarray  # sim link within group (safe 0)
    body: np.ndarray  # env body slot (always valid; for cf accumulation)


class _Job(NamedTuple):
    """Static candidate-contact table. All arrays (C, ...) numpy."""

    a: _Side
    b: _Side
    kind: np.ndarray
    shape_a: np.ndarray  # env shape index
    shape_b: np.ndarray  # env shape index or -1 (plane/heightfield)
    slot: np.ndarray  # sub-slot (corner index etc.)


class _Entity(NamedTuple):
    """One collidable rigid entity (host-side, used at table-build time)."""

    type: int
    free: int
    group: int
    copy: int
    link: int
    body: int


class ContactSolver:
    def __init__(self, scene: Scene, max_pair_shapes: int = MAX_PAIR_SHAPES,
                 device=None):
        self.scene = scene
        self.enabled = False
        self._sw_dev = None  # sphere_world spec, index tensors on one device
        self._nw_dev = None  # neighbor_world spec, index tensors on one device
        self._dev = None  # (device, _Tables) of the contact table
        sh = scene.shapes

        # ---- collidable entities ----
        entities = {}  # body slot -> _Entity
        fg = scene.free_group
        if fg is not None:
            for fi, b in enumerate(fg.body_slot):
                entities[int(b)] = _Entity(T_FREE, fi, 0, 0, 0, int(b))
        for g_id, g in enumerate(scene.art_groups):
            for copy, slot_ in enumerate(g.slots):
                for l, bi in enumerate(g.body_of_link):
                    if bi >= 0:
                        b = int(g.body_start[copy] + bi)
                        entities[b] = _Entity(T_LINK, 0, g_id, copy, l, b)
        static_bodies = []
        if scene.static_group is not None:
            for b in scene.static_group.body_slot:
                entities[int(b)] = _Entity(T_STATIC, 0, 0, 0, 0, int(b))
                static_bodies.append(int(b))

        def shapes_of(b):
            return np.nonzero(sh.body_slot == b)[0].tolist()

        dyn_shapes = []  # (shape_idx, _Entity) for FREE + LINK
        stat_shapes = []
        for b, e in entities.items():
            for s in shapes_of(b):
                if e.type == T_STATIC:
                    stat_shapes.append((s, e))
                else:
                    dyn_shapes.append((s, e))

        # --- dense sphere-world fast path (ops/sphere_world.py): large free
        # sphere sets leave the static table entirely — their sphere-sphere
        # (and, with a plane ground, sphere-ground) contacts are solved as
        # dense (F, F) tiles, by a hand-written kernel on the GPU ---
        from ..ops import sphere_world as _sw

        self.sphere_world = _sw.build_spec(scene)
        sw_shapes = (
            set(self.sphere_world.shape_idx.tolist())
            if self.sphere_world is not None
            else set()
        )
        sw_ground = self.sphere_world.has_ground if self.sphere_world else False

        # --- neighbor-list fast path (ops/neighbor_world.py): large MIXED
        # free-body sets (boxes + spheres) that the pure-sphere path can't
        # take — broadphase is a per-substep (F, K) nearest-neighbor list,
        # so the static O(n^2) table never sees these shapes ---
        from ..ops import neighbor_world as _nw

        self.neighbor_world = _nw.build_spec(
            scene, exclude_sphere_pairs=self.sphere_world is not None
        )
        nw_shapes = (
            set(self.neighbor_world.shape_idx.tolist())
            if self.neighbor_world is not None
            else set()
        )
        nw_ground = self.neighbor_world.has_ground if self.neighbor_world else False
        # ground rows a fast path owns (plane ground only)
        fast_ground_shapes = (sw_shapes if sw_ground else set()) | (
            nw_shapes if nw_ground else set()
        )
        # pairwise rows a fast path owns. A pair leaves the static table
        # only when ONE spec owns BOTH shapes: sphere_world admits spheres
        # with local offsets that neighbor_world rejects, so a sw-sphere vs
        # nw-box pair is generated by NEITHER dense path and must stay here.
        def _fast_pair(si, sj):
            return (si in sw_shapes and sj in sw_shapes) or (
                si in nw_shapes and sj in nw_shapes
            )

        rows: List[tuple] = []  # (ea, eb, kind, sa, sb, slot)
        WORLD = _Entity(T_STATIC, 0, 0, 0, 0, 0)

        def eff_kind(s):
            """Mesh shapes with a convex hull use the hull kinds; hull-less
            meshes (missing blobs) degrade to their bounding box."""
            k = sh.kind[s]
            if k == SHAPE_MESH:
                hid = sh.hull_id[s] if sh.hull_id is not None else -1
                return SHAPE_MESH if hid >= 0 and len(scene.hulls[hid]) >= 4 else SHAPE_BOX
            return k

        # --- plane / heightfield contacts (all dynamic shapes) ---
        if scene.ground is not None or scene.heightfield is not None:
            for s, e in dyn_shapes:
                if s in fast_ground_shapes:
                    continue  # a dense fast path owns this shape's ground
                k = eff_kind(s)
                if k == SHAPE_SPHERE:
                    rows.append((e, WORLD, K_SPH_PLANE, s, -1, 0))
                elif k == SHAPE_CAPSULE:
                    rows.append((e, WORLD, K_CAP_PLANE, s, -1, 0))
                    rows.append((e, WORLD, K_CAP_PLANE, s, -1, 1))
                elif k == SHAPE_MESH:
                    for c in range(_MANIFOLD):
                        rows.append((e, WORLD, K_HULL_PLANE, s, -1, c))
                elif k == SHAPE_BOX:
                    for c in range(8):
                        rows.append((e, WORLD, K_BOX_PLANE, s, -1, c))

        # --- pairwise contacts ---
        def kind_code(ka, kb):
            """List of (code, swap, nslots) narrowphase jobs for a shape pair."""
            M4 = _MANIFOLD
            table = {
                (SHAPE_SPHERE, SHAPE_SPHERE): [(K_SPH_SPH, False, 1)],
                (SHAPE_SPHERE, SHAPE_BOX): [(K_SPH_BOX, False, 1)],
                (SHAPE_BOX, SHAPE_SPHERE): [(K_SPH_BOX, True, 1)],
                (SHAPE_SPHERE, SHAPE_CAPSULE): [(K_SPH_CAP, False, 1)],
                (SHAPE_CAPSULE, SHAPE_SPHERE): [(K_SPH_CAP, True, 1)],
                (SHAPE_CAPSULE, SHAPE_CAPSULE): [(K_CAP_CAP, False, 1)],
                (SHAPE_CAPSULE, SHAPE_BOX): [(K_CAP_BOX, False, 2)],
                (SHAPE_BOX, SHAPE_CAPSULE): [(K_CAP_BOX, True, 2)],
                (SHAPE_BOX, SHAPE_BOX): [
                    (K_BOX_BOX, False, 16),
                    (K_BOX_BOX_EDGE, False, 1),
                ],
                # hull kinds: hull always on side a for *V_BOX/BOXV pairs
                (SHAPE_MESH, SHAPE_BOX): [
                    (K_HULLV_BOX, False, M4),
                    (K_BOXV_HULL, False, M4),
                ],
                (SHAPE_BOX, SHAPE_MESH): [
                    (K_HULLV_BOX, True, M4),
                    (K_BOXV_HULL, True, M4),
                ],
                (SHAPE_MESH, SHAPE_MESH): [
                    (K_HULLV_HULL, False, M4),
                    (K_HULLV_HULL_R, False, M4),
                ],
                (SHAPE_SPHERE, SHAPE_MESH): [(K_SPH_HULL, False, 1)],
                (SHAPE_MESH, SHAPE_SPHERE): [(K_SPH_HULL, True, 1)],
                (SHAPE_CAPSULE, SHAPE_MESH): [(K_CAP_HULL, False, 2)],
                (SHAPE_MESH, SHAPE_CAPSULE): [(K_CAP_HULL, True, 2)],
            }
            return table[(ka, kb)]

        pairs = []
        n_dyn = len(dyn_shapes)
        for i in range(n_dyn):
            si, ei = dyn_shapes[i]
            for j in range(i + 1, n_dyn):
                sj, ej = dyn_shapes[j]
                # two LINK sides of the same group+copy never collide here
                # (self-collision within one articulation is off, like the
                # reference's default create_actor filtering)
                if (
                    ei.type == T_LINK
                    and ej.type == T_LINK
                    and ei.group == ej.group
                    and ei.copy == ej.copy
                ):
                    continue
                if _fast_pair(si, sj):
                    continue  # a single dense fast path owns this pair
                if _pair_allowed(scene, si, sj):
                    pairs.append((si, ei, sj, ej))
            for sj, ej in stat_shapes:
                if _pair_allowed(scene, si, sj):
                    pairs.append((si, ei, sj, ej))
        if len(pairs) > max_pair_shapes:
            raise ValueError(
                f"{len(pairs)} static contact pairs exceeds max_pair_shapes="
                f"{max_pair_shapes}. Large free-body worlds take the dense "
                "fast paths automatically (pure spheres: ops/sphere_world; "
                "mixed sphere/box single-shape actors: ops/neighbor_world) — "
                "this scene's pairs involve articulated links, multi-shape "
                "actors, or meshes at a scale the static table can't hold. "
                "Raise max_pair_shapes explicitly if the memory is acceptable."
            )

        # SDF pair directions, appended in ROW ORDER (each entry = one group
        # of _SDF_MANIFOLD K_PT_SDF rows): (grid index, probe array (P,3),
        # analytic fn or None)
        sdf_pair_meta: List[tuple] = []

        def _has_sdf(s):
            return (
                sh.sdf_id is not None
                and sh.sdf_id[s] >= 0
                and sh.kind[s] == SHAPE_MESH
            )

        def _probes_of(s):
            if sh.sample_id is not None and sh.sample_id[s] >= 0:
                return scene.samples[sh.sample_id[s]]
            hid = sh.hull_id[s] if sh.hull_id is not None else -1
            return scene.hulls[hid] if hid >= 0 else None

        for si, ei, sj, ej in pairs:
            # mesh pairs where a side carries an SDF use probe-vs-SDF contact
            # instead of the convex-hull kinds (hulls can't see concave
            # features like a nut's thread)
            sdf_dirs = []
            if sh.kind[si] == SHAPE_MESH and _has_sdf(sj) and _probes_of(si) is not None:
                sdf_dirs.append((si, ei, sj, ej))
            if sh.kind[sj] == SHAPE_MESH and _has_sdf(si) and _probes_of(sj) is not None:
                sdf_dirs.append((sj, ej, si, ei))
            if sdf_dirs:
                # Direction policy: when a side's SDF has a closed form the
                # probe-vs-analytic direction is exact and gather-free, so the
                # reverse probe-vs-voxel direction adds only voxelization
                # noise. Keep only analytic-target directions when any exist
                # (unless sdf_bidirectional); voxel<->voxel pairs stay
                # bidirectional.
                ana = [
                    d for d in sdf_dirs
                    if scene.sdfs[int(sh.sdf_id[d[2]])].analytic is not None
                ]
                if ana and not scene.sim_params.physx.sdf_bidirectional:
                    sdf_dirs = ana
                for sa, ea, sb_, eb in sdf_dirs:
                    gi = int(sh.sdf_id[sb_])
                    sdf_pair_meta.append((gi, _probes_of(sa), scene.sdfs[gi].analytic))
                    for c in range(_SDF_MANIFOLD):
                        rows.append((ea, eb, K_PT_SDF, sa, sb_, c))
                continue
            for code, swap, nslots in kind_code(eff_kind(si), eff_kind(sj)):
                ssi, ssj, eei, eej = (sj, si, ej, ei) if swap else (si, sj, ei, ej)
                for c in range(nslots):
                    rows.append((eei, eej, code, ssi, ssj, c))

        if not rows:
            self.num_contacts = 0
            self.enabled = (
                self.sphere_world is not None or self.neighbor_world is not None
            )
            self.link_lists = [
                (np.zeros(0, np.int32), np.zeros(0, np.int32))
                for _ in scene.art_groups
            ]
            self.any_link = False
            return
        self.enabled = True

        def side(get):
            return _Side(
                type=np.asarray([get(r).type for r in rows], np.int32),
                free=np.asarray([get(r).free for r in rows], np.int32),
                group=np.asarray([get(r).group for r in rows], np.int32),
                copy=np.asarray([get(r).copy for r in rows], np.int32),
                link=np.asarray([get(r).link for r in rows], np.int32),
                body=np.asarray([get(r).body for r in rows], np.int32),
            )

        self.job = _Job(
            a=side(lambda r: r[0]),
            b=side(lambda r: r[1]),
            kind=np.asarray([r[2] for r in rows], np.int32),
            shape_a=np.asarray([r[3] for r in rows], np.int32),
            shape_b=np.asarray([r[4] for r in rows], np.int32),
            slot=np.asarray([r[5] for r in rows], np.int32),
        )
        self.num_contacts = len(rows)

        # per-group static contact index lists (which contacts touch links
        # of group g on side a / side b)
        self.link_lists = []
        for g_id in range(len(scene.art_groups)):
            ia = np.nonzero((self.job.a.type == T_LINK) & (self.job.a.group == g_id))[0]
            ib = np.nonzero((self.job.b.type == T_LINK) & (self.job.b.group == g_id))[0]
            self.link_lists.append((ia.astype(np.int32), ib.astype(np.int32)))
        self.any_link = any(len(ia) + len(ib) for ia, ib in self.link_lists)

        # static one-hot (B_env, C) matrices: per-body segment reductions in
        # the solve are matmuls with them instead of scatter-adds
        C = self.num_contacts
        B_env = scene.num_bodies_per_env
        job = self.job

        def oh_body(side_body, row_mask):
            m = np.zeros((B_env, C), np.float32)
            rows_i = np.nonzero(row_mask)[0]
            m[side_body[rows_i], rows_i] = 1.0
            return m

        resp_a = job.a.type != T_STATIC
        resp_b = (job.b.type != T_STATIC) & (job.shape_b >= 0)
        self._oh_cnt_a = oh_body(job.a.body, resp_a)
        self._oh_cnt_b = oh_body(job.b.body, resp_b)
        self._oh_cf_a = oh_body(job.a.body, np.ones(C, bool))
        self._oh_cf_b = oh_body(job.b.body, job.shape_b >= 0)

        # heightfield terrain: contact stays heightfield-native
        hf = scene.heightfield
        if hf is not None:
            self.hf_data = np.asarray(hf.data, np.float32)
            self.hf_scale = float(hf.horizontal_scale)
            self.hf_off = (float(hf.offset_x), float(hf.offset_y))
        else:
            self.hf_data = None
        # plane params
        pl = scene.ground
        if pl is not None:
            n = np.asarray(pl.normal, np.float32)
            n = n / max(np.linalg.norm(n), 1e-9)
            self.plane_n = n
            self.plane_d = np.float32(pl.distance)
            self.plane_friction = np.float32(pl.static_friction)
            self.plane_restitution = np.float32(pl.restitution)
        else:
            self.plane_n = np.array([0, 0, 1], np.float32)
            self.plane_d = np.float32(0)
            self.plane_friction = np.float32(1.0)
            self.plane_restitution = np.float32(0.0)

        # convex hull tables: every hull's vertices padded with its centroid,
        # its face planes [n, d] (n.x + d <= 0 inside) with a never-binding
        # face, to the scene's largest hull
        self.hull_verts = self.hull_planes = None
        if scene.hulls:
            plane_list = [_hull_planes(hv) for hv in scene.hulls]
            Vmax = max(len(h) for h in scene.hulls)
            fmax = max([4] + [len(eq) for eq in plane_list])
            verts, planes = [], []
            for hv, eq in zip(scene.hulls, plane_list):
                pad = np.tile(hv.mean(0), (Vmax - len(hv), 1))
                verts.append(np.concatenate([hv, pad], 0))
                peq = np.tile(np.array([[0, 0, 1, -1e9]], np.float32), (fmax - len(eq), 1))
                planes.append(np.concatenate([eq, peq], 0))
            self.hull_verts = np.stack(verts).astype(np.float32)
            self.hull_planes = np.stack(planes).astype(np.float32)

        # SDF tables: the pair directions partitioned into evaluation
        # families (voxel rows gather from one stacked (K, R, R, R) grid;
        # analytic rows evaluate their closed form, one family per distinct
        # fn), and every direction's probes padded to one length
        self.sdf_probes = self.sdf_data = None
        if sdf_pair_meta:
            voxel_q = [qi for qi, m in enumerate(sdf_pair_meta) if m[2] is None]
            self.sdf_voxel_q = np.asarray(voxel_q, np.int32)
            ana_groups: dict = {}
            for qi, m in enumerate(sdf_pair_meta):
                if m[2] is not None:
                    ana_groups.setdefault(id(m[2]), (m[2], []))[1].append(qi)
            self.sdf_analytic_groups = [
                (fn, np.asarray(qs, np.int32)) for fn, qs in ana_groups.values()
            ]
            if voxel_q:
                # stack only the grids voxel rows reference (an analytic-only
                # grid never uploads its voxels)
                gids = sorted({sdf_pair_meta[qi][0] for qi in voxel_q})
                remap = {g: i for i, g in enumerate(gids)}
                grids = [scene.sdfs[g] for g in gids]
                R = grids[0].data.shape[0]
                assert all(
                    g.data.shape == (R, R, R) for g in grids
                ), "all SDF grids in a scene must share one resolution"
                self.sdf_data = np.stack([g.data for g in grids]).astype(np.float32)
                self.sdf_origin = np.stack([g.origin for g in grids]).astype(np.float32)
                self.sdf_spacing = np.stack([g.spacing for g in grids]).astype(np.float32)
                self.sdf_voxel_grid = np.asarray(
                    [remap[sdf_pair_meta[qi][0]] for qi in voxel_q], np.int32
                )
            # a multiple of the manifold size: selection is strided-grouped
            # (slot m picks over probes {g*M + m}), so the length is G*M
            M = _SDF_MANIFOLD
            pmax = max(len(m[1]) for m in sdf_pair_meta)
            pmax = -(-pmax // M) * M
            probes = []
            for _, pr, _fn in sdf_pair_meta:
                pr = np.asarray(pr, np.float32)
                if len(pr) < pmax:
                    # pad with a FAR sentinel (outside any grid -> phi >> 0,
                    # never a contact), not repeated probes, which would put
                    # duplicate impulses on one point
                    far = np.full((pmax - len(pr), 3), 1e3, np.float32)
                    pr = np.concatenate([pr, far], 0)
                probes.append(pr)
            self.sdf_probes = np.stack(probes)

        if device is not None:
            self._tables(torch.empty(0, device=device).device)

    # ------------------------------------------------------------------
    def _tables(self, dev):
        """The contact table's device tensors on `dev` (_Tables), made once
        per device: narrowphase and the solve upload nothing."""
        if self._dev is None or self._dev[0] != dev:
            self._dev = (dev, _Tables(self, dev))
        return self._dev[1]

    def _sphere_world_on(self, dev):
        """(spec with its device mask, free, shape, body index tensors) of
        the sphere world on `dev`, made once per device: the one place the
        mask is uploaded on the main path."""
        if self._sw_dev is None or self._sw_dev[0] != dev:
            spec = self.sphere_world
            idx = [torch.as_tensor(a, dtype=torch.long, device=dev)
                   for a in (spec.free_idx, spec.shape_idx, spec.body_slot)]
            self._sw_dev = (dev, spec.to(dev), *idx)
        return self._sw_dev[1:]

    def _sphere_world_inputs(self, body_pos, free_v, free_w, free_m, free_I_w, params, h):
        """The arguments of ops/sphere_world.solve for this substep."""
        spec, fidx, sidx, bidx = self._sphere_world_on(body_pos.device)
        pos = body_pos[:, bidx]
        vel = free_v[:, fidx]
        omega = free_w[:, fidx]
        radius = params.shape_size[:, sidx, 0].contiguous()
        inv_m = 1.0 / free_m[:, fidx]
        # spheres: world inertia is isotropic; 3/trace is exact there
        tr = (
            free_I_w[:, fidx, 0, 0]
            + free_I_w[:, fidx, 1, 1]
            + free_I_w[:, fidx, 2, 2]
        )
        inv_i = 3.0 / tr.clamp_min(1e-9)
        mu = params.shape_friction[:, sidx]
        rest = params.shape_restitution[:, sidx]
        px = self.scene.sim_params.physx
        iters = max(6, 2 * px.num_position_iterations) + px.num_velocity_iterations
        slop = px.rest_offset + px.contact_slop
        return (
            spec, pos, vel, omega, radius, inv_m, inv_i, mu, rest,
            h, iters, px.contact_offset, slop, px.bounce_threshold_velocity,
        )

    def _neighbor_world_on(self, dev):
        """(spec with its device tensors, free, shape, body index tensors)
        of the neighbor world on `dev`, made once per device."""
        if self._nw_dev is None or self._nw_dev[0] != dev:
            spec = self.neighbor_world
            idx = [torch.as_tensor(a, dtype=torch.long, device=dev)
                   for a in (spec.free_idx, spec.shape_idx, spec.body_slot)]
            self._nw_dev = (dev, spec.to(dev), *idx)
        return self._nw_dev[1:]

    def _solve_neighbor_world(self, body_pos, body_quat, free_v, free_w, free_m, free_I_w,
                              params, h, cf_base):
        """Neighbor-list solve of the large mixed free-body set
        (ops/neighbor_world.py). Runs after the sphere-world solve and
        before the table solve; they share velocities in that order."""
        from ..ops import neighbor_world as _nw

        spec, fidx, sidx, bidx = self._neighbor_world_on(body_pos.device)
        px = self.scene.sim_params.physx
        iters = max(6, 2 * px.num_position_iterations) + px.num_velocity_iterations
        slop = px.rest_offset + px.contact_slop
        inv_I = spd_inv(free_I_w[:, fidx])
        # fold the local shape offset/rotation into the pose fed to the
        # solver: it sees SHAPE centers and center velocities; single-geom
        # bodies have com == center, so the inertia arms stay exact. Offsets
        # are the runtime shape_pos, so randomization shows up.
        bp = body_pos[:, bidx]
        bq = body_quat[:, bidx]
        arm = quat_rotate(bq, params.shape_pos[:, sidx])
        center = bp + arm
        sq = quat_mul(bq, spec.local_quat[None])
        w0 = free_w[:, fidx]
        vc = free_v[:, fidx] + cross(w0, arm)
        v1c, w1, cf_s = _nw.solve(
            spec, center, sq, vc, w0, params.shape_size[:, sidx], 1.0 / free_m[:, fidx],
            inv_I, params.shape_friction[:, sidx], params.shape_restitution[:, sidx],
            h, iters, px.contact_offset, slop, px.bounce_threshold_velocity,
            max_depen=px.max_depenetration_velocity,
        )
        v1 = v1c - cross(w1, arm)
        free_v = free_v.index_copy(1, fidx, v1)
        free_w = free_w.index_copy(1, fidx, w1)
        return free_v, free_w, cf_base.index_add(1, bidx, cf_s)

    # ------------------------------------------------------------------
    def shape_poses(self, body_pos, body_quat, params):
        """(pa, qa, pb, qb, size_a, size_b) (N, C, .): each row's side-a and
        side-b shape pose and runtime size, from the body poses."""
        t = self._tables(body_pos.device)

        def shape_pose(owner, shape, squat):
            bp, bq = body_pos[:, owner], body_quat[:, owner]
            return quat_rotate(bq, params.shape_pos[:, shape]) + bp, quat_mul(bq, squat)

        pa, qa = shape_pose(t.owner_a, t.shape_a, t.squat_a)
        pb, qb = shape_pose(t.owner_b, t.shape_b, t.squat_b)
        return pa, qa, pb, qb, params.shape_size[:, t.shape_a], params.shape_size[:, t.shape_b]

    def sdf_rows(self, pa, qa, pb, qb, size_a, size_b):
        """(point, normal, depth) of the K_PT_SDF rows, q-major, from
        `shape_poses`: the SDF narrowphase alone."""
        t = self._tables(pa.device)
        i = dict(t.kinds)[K_PT_SDF]
        return _sdf_narrowphase(t.sdf, pa[:, i], qa[:, i], pb[:, i], qb[:, i], size_a[:, i],
                                size_b[:, i])

    # ------------------------------------------------------------------
    def narrowphase(self, body_pos, body_quat, params):
        """(point, normal(b->a), depth, active) for every candidate contact,
        given CURRENT body poses (N, B, 3/4).

        Each contact kind computes only over its own static row subset; the
        kinds' results are concatenated and put in row order by one static
        inverse-permutation gather per output."""
        t = self._tables(body_pos.device)
        pa, qa, pb, qb, size_a, size_b = self.shape_poses(body_pos, body_quat, params)
        pn, pd = t.plane_n, float(self.plane_d)

        if t.hf is not None:
            def ground(p):
                return _heightfield_sdf(t.hf, self.hf_scale, self.hf_off, p, t.hf_corner)
        else:
            def ground(p):
                return (p * pn).sum(-1) - pd, pn.expand(p.shape)

        def hull_verts(code, i, p_, q_, size):
            """World vertices (N, P, V, 3) of each pair's vertex hull, on
            side p_/q_/size of rows i, scaled by runtime / static size."""
            sig = size[:, i] / t.hull_v_size[code]
            v_loc = t.hull_v[code][None] * sig[:, :, None, :]
            return quat_rotate(q_[:, i, None], v_loc) + p_[:, i, None]

        def in_hull(code, i, p_, q_, size, x):
            """Signed distance (N, P, K) and outward world normal of points
            x (N, P, K, 3) against each pair's plane hull: the largest face
            distance, and the mean normal of the faces that reach it."""
            planes = t.hull_p[code]  # (P, F, 4)
            sig = size[:, i] / t.hull_p_size[code]  # (N, P, 3)
            sig_u = sig.mean(-1)  # uniform-scale approximation
            q_i = q_[:, i, None]
            rel = quat_rotate(quat_conjugate(q_i), x - p_[:, i, None])
            rel = rel / sig.clamp_min(1e-6)[:, :, None, :]
            pl = planes[None, :, None]  # (1, P, 1, F, 4)
            s_f = (rel[..., 0, None] * pl[..., 0] + rel[..., 1, None] * pl[..., 1]
                   + rel[..., 2, None] * pl[..., 2] + pl[..., 3])  # (N, P, K, F)
            sd_raw = s_f.max(-1).values
            # the faces at the maximum, averaged (a tie of two faces gives
            # the mean of their normals, renormalized below)
            m = (s_f >= sd_raw[..., None]).to(s_f.dtype)
            m = m / m.sum(-1, keepdim=True).clamp_min(1.0)
            n_loc = torch.einsum("npkf,pfc->npkc", m, planes[..., :3])
            n_len = torch.sqrt((n_loc * n_loc).sum(-1).clamp_min(1e-12))
            return sd_raw * sig_u[..., None], quat_rotate(q_i, n_loc / n_len[..., None])

        def top4(pts, nrm, deps):
            """The _MANIFOLD deepest of each pair's candidates (N, P, K):
            (point, normal, depth) of rows (N, P * _MANIFOLD), deepest
            first. Each pass takes the first candidate at the maximum (the
            JAX package's one-hot of `d >= max` cut to its first column by
            a cumulative sum; torch.max returns that first index) and masks
            it out."""
            N_, P = deps.shape[:2]
            d, vals, idx = deps, [], []
            for _ in range(_MANIFOLD):
                m, j = d.max(-1)
                vals.append(m)
                idx.append(j)
                d = d.scatter(-1, j[..., None], float("-inf"))
            j = torch.stack(idx, -1)[..., None].expand(N_, P, _MANIFOLD, 3)
            return (torch.gather(pts, 2, j).reshape(N_, P * _MANIFOLD, 3),
                    torch.gather(nrm.expand(pts.shape), 2, j).reshape(N_, P * _MANIFOLD, 3),
                    torch.stack(vals, -1).reshape(N_, P * _MANIFOLD))

        def cap_axis(q):
            return quat_rotate(q, t.ez)

        def point_vs_box(pt_w, pb_i, qb_i, szb, r):
            """Sphere(-like) point vs box b: (pt, n, dep)."""
            rel = quat_rotate(quat_conjugate(qb_i), pt_w - pb_i)
            clamped = torch.clamp(rel, -szb, szb)
            inside = (rel.abs() <= szb).all(-1)
            pen_ax = szb - rel.abs()
            ax = torch.argmin(pen_ax, -1)
            sgn = torch.sign(torch.gather(rel, -1, ax[..., None]))[..., 0]
            onehot = t.eye3[ax]
            val = sgn * torch.gather(szb, -1, ax[..., None])[..., 0]
            surf = torch.where(
                inside[..., None],
                clamped * (1.0 - onehot) + onehot * val[..., None],
                clamped,
            )
            cp_w = pb_i + quat_rotate(qb_i, surf)
            dvec = pt_w - cp_w
            dist = torch.linalg.vector_norm(dvec, dim=-1).clamp_min(1e-9)
            n = torch.where(
                inside[..., None],
                quat_rotate(qb_i, onehot * sgn[..., None]),
                dvec / dist[..., None],
            )
            dep = torch.where(inside, r + dist, r - dist)
            return cp_w, n, dep

        parts = []  # (point, normal, depth) per kind, in t.kinds order
        for code, i in t.kinds:
            if code == K_SPH_PLANE:
                r = size_a[:, i, 0]
                d, n = ground(pa[:, i])
                parts.append((pa[:, i] - n * r[..., None], n, r - d))
            elif code == K_CAP_PLANE:
                r, hl = size_a[:, i, 0], size_a[:, i, 1]
                endp = pa[:, i] + cap_axis(qa[:, i]) * (hl * t.end_sign[code])[..., None]
                d, n = ground(endp)
                parts.append((endp - n * r[..., None], n, r - d))
            elif code == K_BOX_PLANE:
                cw = pa[:, i] + quat_rotate(qa[:, i], t.corners[code] * size_a[:, i])
                d, n = ground(cw)
                parts.append((cw, n, -d))
            elif code == K_SPH_SPH:
                r_a, r_b = size_a[:, i, 0], size_b[:, i, 0]
                dvec = pa[:, i] - pb[:, i]
                dist = torch.linalg.vector_norm(dvec, dim=-1).clamp_min(1e-9)
                n = dvec / dist[..., None]
                parts.append((pb[:, i] + n * r_b[..., None], n, (r_a + r_b) - dist))
            elif code == K_SPH_BOX:
                parts.append(point_vs_box(pa[:, i], pb[:, i], qb[:, i], size_b[:, i],
                                          size_a[:, i, 0]))
            elif code == K_SPH_CAP:
                r_a, r_b, hl_b = size_a[:, i, 0], size_b[:, i, 0], size_b[:, i, 1]
                zb = cap_axis(qb[:, i])
                s = torch.clamp(((pa[:, i] - pb[:, i]) * zb).sum(-1), -hl_b, hl_b)
                seg = pb[:, i] + zb * s[..., None]
                dvec = pa[:, i] - seg
                dist = torch.linalg.vector_norm(dvec, dim=-1).clamp_min(1e-9)
                n = dvec / dist[..., None]
                parts.append((seg + n * r_b[..., None], n, (r_a + r_b) - dist))
            elif code == K_CAP_CAP:
                r_a, hl_a = size_a[:, i, 0], size_a[:, i, 1]
                r_b, hl_b = size_b[:, i, 0], size_b[:, i, 1]
                za, zb = cap_axis(qa[:, i]), cap_axis(qb[:, i])
                a0 = pa[:, i] - za * hl_a[..., None]
                a1 = pa[:, i] + za * hl_a[..., None]
                b0 = pb[:, i] - zb * hl_b[..., None]
                b1 = pb[:, i] + zb * hl_b[..., None]
                pA, pB = _segment_closest(a0, a1, b0, b1)
                dvec = pA - pB
                dist = torch.linalg.vector_norm(dvec, dim=-1).clamp_min(1e-9)
                n = dvec / dist[..., None]
                parts.append((pB + n * r_b[..., None], n, (r_a + r_b) - dist))
            elif code == K_CAP_BOX:
                r_a, hl_a = size_a[:, i, 0], size_a[:, i, 1]
                cap_pt = pa[:, i] + cap_axis(qa[:, i]) * (hl_a * t.end_sign[code])[..., None]
                szb, pb_i, qb_i = size_b[:, i], pb[:, i], qb[:, i]
                rel = quat_rotate(quat_conjugate(qb_i), cap_pt - pb_i)
                cp = pb_i + quat_rotate(qb_i, torch.clamp(rel, -szb, szb))
                dv = cap_pt - cp
                dist = torch.linalg.vector_norm(dv, dim=-1).clamp_min(1e-9)
                parts.append((cp, dv / dist[..., None], r_a - dist))
            elif code == K_BOX_BOX:
                parts.append(_box_box_face(
                    pa[:, i], qa[:, i], size_a[:, i], pb[:, i], qb[:, i], size_b[:, i],
                    t.corners[code], t.bb_is_av,
                    self.scene.sim_params.physx.contact_offset,
                ))
            elif code == K_BOX_BOX_EDGE:
                parts.append(_box_box_edge(
                    pa[:, i], qa[:, i], size_a[:, i], pb[:, i], qb[:, i], size_b[:, i]
                ))
            elif code == K_HULL_PLANE:  # hull(a) verts vs ground or heightfield
                w = hull_verts(code, i, pa, qa, size_a)
                d, n = ground(w)
                parts.append(top4(w, n, -d))
            elif code == K_HULLV_BOX:  # hull(a) verts in box(b): point vs box, r = 0
                w = hull_verts(code, i, pa, qa, size_a)
                pb_i, qb_i, szb = pb[:, i, None], qb[:, i, None], size_b[:, i, None]
                rel = quat_rotate(quat_conjugate(qb_i), w - pb_i)
                cl = torch.clamp(rel, -szb, szb)
                pen = szb - rel.abs()
                inside = (pen >= 0).all(-1)
                m = torch.minimum(pen[..., 0], torch.minimum(pen[..., 1], pen[..., 2]))
                is_x = pen[..., 0] <= m
                is_y = ~is_x & (pen[..., 1] <= m)
                sel = torch.stack([is_x, is_y, ~is_x & ~is_y], -1)
                sgn = torch.sign(rel)
                surf = torch.where(inside[..., None] & sel, sgn * szb, cl)
                dv = w - (quat_rotate(qb_i, surf) + pb_i)
                dist = torch.sqrt(dv[..., 0] ** 2 + dv[..., 1] ** 2 + dv[..., 2] ** 2
                                  ).clamp_min(1e-9)
                n_in = quat_rotate(qb_i, torch.where(sel, sgn, 0.0))
                n = torch.where(inside[..., None], n_in, dv / dist[..., None])
                parts.append(top4(w, n, torch.where(inside, dist, -dist)))
            elif code == K_BOXV_HULL:  # box(b) corners in hull(a)
                cw = quat_rotate(qb[:, i, None], t.box8 * size_b[:, i, None]) + pb[:, i, None]
                sd, n_out = in_hull(code, i, pa, qa, size_a, cw)
                parts.append(top4(cw, -n_out, -sd))
            elif code == K_HULLV_HULL:  # hull(a) verts in hull(b)
                w = hull_verts(code, i, pa, qa, size_a)
                sd, n_out = in_hull(code, i, pb, qb, size_b, w)
                parts.append(top4(w, n_out, -sd))
            elif code == K_HULLV_HULL_R:  # hull(b) verts in hull(a)
                w = hull_verts(code, i, pb, qb, size_b)
                sd, n_out = in_hull(code, i, pa, qa, size_a, w)
                parts.append(top4(w, -n_out, -sd))
            elif code in (K_SPH_HULL, K_CAP_HULL):  # sphere(a) / capsule end(a) vs hull(b)
                r = size_a[:, i, 0]
                c = pa[:, i]
                if code == K_CAP_HULL:  # both ends in one pass, by end_sign
                    c = c + cap_axis(qa[:, i]) * (size_a[:, i, 1] * t.end_sign[code])[..., None]
                sd, n_out = in_hull(code, i, pb, qb, size_b, c[:, :, None])
                n1 = n_out[:, :, 0]
                parts.append((c - n1 * r[..., None], n1, r - sd[:, :, 0]))
            elif code == K_PT_SDF:
                parts.append(self.sdf_rows(pa, qa, pb, qb, size_a, size_b))
            else:
                raise NotImplementedError(f"contact kind {code}")

        point = torch.cat([p[0] for p in parts], 1)[:, t.inv]
        normal = torch.cat([p[1] for p in parts], 1)[:, t.inv]
        depth = torch.cat([p[2] for p in parts], 1)[:, t.inv]
        if _debug.enabled():  # TIG_DEBUG invariants
            _debug.assert_contact_tables(point, normal, depth, body_pos.shape[0],
                                         self.num_contacts)
        active = depth > -self.scene.sim_params.physx.contact_offset
        return point, normal, depth, active

    # ------------------------------------------------------------------
    def solve(
        self,
        body_pos,
        body_quat,
        body_vel_kin,
        free_v,
        free_w,
        free_m,
        free_I_w,
        free_com_w,
        art_qd,
        art_jac,
        art_Ainv,
        params,
        h,
        warm=None,
    ):
        """Velocity-level contact solve over free bodies and articulations.

        body_pos/quat: CURRENT poses of every env body (N, B, 3/4).
        body_vel_kin: (linvel, angvel) (N, B, 3) — surface velocity of
            kinematic (STATIC) colliders.
        free_*: free-body batch tensors (None when there are no free bodies).
        art_qd: list per group of (N, K, nv) generalized velocities.
        art_jac: list per group of (N, K, Ls, 6, nv) link jacobians (rows
            [lin; ang] of link origins) or None if the group has no contacts.
        art_Ainv: list per group of (N, K, nv, nv) inverse implicit operators.
        warm: optional (lam_n (N, C), lam_t (N, C, 3)) impulses from the
            previous substep or step, applied up front and refined.
        Returns (free_v, free_w, art_qd, contact_force (N, B, 3),
        (lam_n, lam_t) or None)."""
        from ..ops import sphere_world as _sw

        N = body_pos.shape[0]
        B_env = self.scene.num_bodies_per_env
        cf = torch.zeros((N, B_env, 3), dtype=body_pos.dtype, device=body_pos.device)
        if not self.enabled:
            return free_v, free_w, list(art_qd), cf, None
        if self.sphere_world is not None and free_m is not None:
            args = self._sphere_world_inputs(
                body_pos, free_v, free_w, free_m, free_I_w, params, h
            )
            _, fidx, _, bidx = self._sphere_world_on(body_pos.device)
            v1, w1, cf_s = _sw.solve(*args)
            free_v = free_v.index_copy(1, fidx, v1)
            free_w = free_w.index_copy(1, fidx, w1)
            cf = cf.index_add(1, bidx, cf_s)
        if self.neighbor_world is not None and free_m is not None:
            free_v, free_w, cf = self._solve_neighbor_world(
                body_pos, body_quat, free_v, free_w, free_m, free_I_w, params, h, cf
            )
        if self.num_contacts == 0:
            return free_v, free_w, list(art_qd), cf, None

        s = self.prepare(body_pos, body_quat, body_vel_kin, free_v, free_w, free_m,
                         free_I_w, free_com_w, art_qd, art_jac, art_Ainv, params, h, warm)
        for _ in range(s.iters):
            s.sweep()
        # back from u: free bodies first, then each group's copies
        u, t = s.u, s.t
        if s.have_free:
            free_v = u[:, :t.F, 0:3].contiguous()
            free_w = u[:, :t.F, 3:6].contiguous()
        art_qd = [u[:, o:o + qd.shape[1], :qd.shape[-1]].contiguous()
                  for o, qd in zip(t.group_row, art_qd)]
        # net contact force per ENV BODY (normal impulses / h), symmetric
        f_n = torch.where(s.active, s.lam, 0.0) * (1.0 / h)
        cf = cf + t.oh_cf @ (f_n[..., None] * s.normal)
        return free_v, free_w, art_qd, cf, (s.lam, s.lt)

    # ------------------------------------------------------------------
    def prepare(self, body_pos, body_quat, body_vel_kin, free_v, free_w, free_m,
                free_I_w, free_com_w, art_qd, art_jac, art_Ainv, params, h, warm=None):
        """Everything of the table solve before its Jacobi sweeps (the
        arguments are `solve`'s): narrowphase, materials, mass splitting,
        the sides' Jacobians and effective masses, the targets, and the
        warm start applied. Returns the _Solve whose `sweep` runs one
        iteration."""
        t = self._tables(body_pos.device)
        N = body_pos.shape[0]
        have_free = free_m is not None and t.F > 0
        point, normal, depth, active = self.narrowphase(body_pos, body_quat, params)
        C, Dm = self.num_contacts, t.Dmax

        # --- material params per contact: PhysX's default combine mode,
        # the average ---
        mu = 0.5 * (params.shape_friction[:, t.shape_a] + torch.where(
            t.has_b, params.shape_friction[:, t.shape_b], float(self.plane_friction)))
        rest = 0.5 * (params.shape_restitution[:, t.shape_a] + torch.where(
            t.has_b, params.shape_restitution[:, t.shape_b], float(self.plane_restitution)))

        # --- mass-splitting Jacobi scale: each responding body's inverse
        # mass is divided by its ACTIVE contact count (a one-hot matmul) ---
        cnt = (active.to(point.dtype) @ t.oh_cnt).clamp_min(1.0)  # (N, B_env)
        split = (1.0 / cnt[:, t.body_a], 1.0 / cnt[:, t.body_b])

        # --- per side: J (N, C, 3, Dmax) from the entity's generalized
        # velocity to the contact point's, M^-1 J^T (N, C, Dmax, 3), and the
        # side's inverse effective mass along a unit d, 1/m + d^T K d: a free
        # body's 1/m (N, C) and K = (r x)^T I^-1 (r x), a link's K = Jp A^-1
        # Jp^T (N, C, 3, 3). 1/m stays out of K as in the JAX package, whose
        # effective mass along a degenerate (zero) normal is 1/m, not 0. TRUE
        # inverse masses drive the effective mass; the application is
        # mass-split ---
        if have_free:
            inv_m = 1.0 / free_m
            inv_I = spd_inv(free_I_w)

        def side(s):
            if have_free:
                fi, mk = t.free[s], t.free_mask[s]
                im = torch.where(mk, inv_m[:, fi], 0.0)
                iI = torch.where(mk[:, None, None], inv_I[:, fi], 0.0)
                S = skew(point - free_com_w[:, fi])
                iIS = iI @ S
                # J u = v - r x w = v + w x r; M^-1 J^T imp = [imp/m, I^-1 (r x imp)]
                J = torch.cat([t.eye3.expand(N, C, 3, 3), -S], -1) * mk[:, None, None]
                MJ = torch.cat([im[..., None, None] * t.eye3, iIS], -2)
                J = _pad(J, -1, Dm)
                MJ = _pad(MJ, -2, Dm)
                K = -(S @ iIS)
            else:
                im = point.new_zeros((N, C))
                J = point.new_zeros((N, C, 3, Dm))
                MJ = point.new_zeros((N, C, Dm, 3))
                K = point.new_zeros((N, C, 3, 3))
            for g, idx, cp, link, lb in t.links[s]:
                Jl = art_jac[g][:, cp, link]  # (N, Cg, 6, nv)
                rr = point[:, idx] - body_pos[:, lb]
                # columns of the point's linear Jacobian: lin - r x ang
                Jp = Jl[:, :, :3] - cross(rr[:, :, None, :], Jl[:, :, 3:].transpose(-1, -2)
                                          ).transpose(-1, -2)
                W0 = art_Ainv[g][:, cp] @ Jp.transpose(-1, -2)  # (N, Cg, nv, 3)
                J = J.index_copy(1, idx, _pad(Jp, -1, Dm))
                MJ = MJ.index_copy(1, idx, _pad(W0, -2, Dm))
                K = K.index_copy(1, idx, Jp @ W0)
            return J, MJ, im, K

        J_a, MJ_a, im_a, K_a = side(0)
        J_b, MJ_b, im_b, K_b = side(1)
        s = _Solve(t, have_free, normal, active, mu)
        s.im, s.K = im_a + im_b, K_a + K_b
        s.J_ab = torch.cat([J_a, -J_b], -1)  # (N, C, 3, 2 Dmax)
        s.W_ab = torch.cat([split[0][..., None, None] * MJ_a,
                            -(split[1][..., None, None] * MJ_b)], -2)  # (N, C, 2 Dmax, 3)

        # --- kinematic surface velocity (statics; zero for the world plane) ---
        kin_lin, kin_ang = body_vel_kin

        def kin_vel(body, is_kin):
            v = kin_lin[:, body] + cross(kin_ang[:, body], point - body_pos[:, body])
            return torch.where(is_kin[:, None], v, 0.0)

        s.vkin = kin_vel(t.body_a, t.kin_a) - kin_vel(t.body_b, t.kin_b)

        # --- the entities' generalized velocities, u (N, E + 1, Dmax); the
        # last row is the zero row static sides read ---
        rows = [_pad(torch.cat([free_v, free_w], -1), -1, Dm)] if have_free else []
        rows += [_pad(qd, -1, Dm) for qd in art_qd]
        rows.append(point.new_zeros((N, 1, Dm)))
        s.u = torch.cat(rows, 1)

        px = self.scene.sim_params.physx
        beta = 0.2
        slop = px.rest_offset + px.contact_slop
        h_inv = 1.0 / h
        bias = torch.clamp_max(
            beta * h_inv * torch.clamp_min(depth - slop, 0.0), px.max_depenetration_velocity
        )
        vn0 = (s.rel_vel(s.u) * normal).sum(-1)
        bounce = torch.where(vn0 < -px.bounce_threshold_velocity, -rest * vn0, 0.0)
        # speculative contact: a separated row may close at most its gap
        s.target_vn = torch.where(
            depth > slop, torch.maximum(bias, bounce), (depth - slop) * h_inv
        )
        s.rk_n = RELAX * s.eff_mass(normal)
        s.iters = max(6, 2 * px.num_position_iterations) + px.num_velocity_iterations

        s.lam = point.new_zeros((N, C))
        s.lt = point.new_zeros((N, C, 3))
        if warm is not None and warm[0] is not None:
            # warm start: re-apply the previous impulses on still-active
            # rows up front, then refine the deltas
            s.lam = torch.where(active, warm[0], 0.0)
            s.lt = torch.where(active[..., None], warm[1], 0.0)
            s.u = s.apply_impulse(s.u, s.lam[..., None] * normal + s.lt)
        return s


class _Solve:
    """One table solve between `ContactSolver.prepare` and the end of its
    sweeps: the per-contact operators (set by `prepare`) and the iterate
    (u, lam, lt)."""

    def __init__(self, t, have_free, normal, active, mu):
        self.t, self.have_free = t, have_free
        self.normal, self.active, self.mu = normal, active, mu

    # The per-contact products below are broadcast multiplies and sums, not
    # matmuls: cuBLAS runs a (N*C)-batch of 3x18 products as batched gemv in
    # chunks of 65,535, ~5x the device time of reading the operands once.

    def rel_vel(self, u):
        """Relative velocity (side a - side b) at every contact point."""
        N, C = self.normal.shape[:2]
        ug = u[:, self.t.ent_ab].reshape(N, C, 1, -1)
        return (self.J_ab * ug).sum(-1) + self.vkin

    def apply_impulse(self, u, imp):
        """+imp on side a, -imp on side b; each entity receives its
        mass-split share through one one-hot matmul."""
        N, C = self.normal.shape[:2]
        du = (self.W_ab * imp[..., None, :]).sum(-1).reshape(N, 2 * C, -1)
        return u + self.t.oh_ent @ du

    def eff_mass(self, d):
        q = self.im + (d[..., :, None] * self.K * d[..., None, :]).sum((-2, -1))
        return 1.0 / q.clamp_min(1e-9)

    def sweep(self):
        """One relaxed-Jacobi iteration over every row."""
        normal, active, lam, lt = self.normal, self.active, self.lam, self.lt
        vr = self.rel_vel(self.u)
        vn = (vr * normal).sum(-1)
        new_lam = (lam + self.rk_n * (self.target_vn - vn)).clamp_min(0.0)
        dl = torch.where(active, new_lam - lam, 0.0)
        # friction: ACCUMULATED tangential impulse on the Coulomb cone
        vt = vr - vn[..., None] * normal
        t_dir = vt / torch.sqrt((vt * vt).sum(-1).clamp_min(1e-18))[..., None]
        lt_raw = lt - (RELAX * self.eff_mass(t_dir))[..., None] * vt
        tnorm = torch.sqrt((lt_raw * lt_raw).sum(-1).clamp_min(1e-18))
        new_lt = lt_raw * torch.clamp_max(self.mu * new_lam / tnorm, 1.0)[..., None]
        imp = dl[..., None] * normal + torch.where(active[..., None], new_lt - lt, 0.0)
        self.u = self.apply_impulse(self.u, imp)
        self.lam, self.lt = new_lam, new_lt


class _Tables:
    """Device tensors of one ContactSolver's table, built once per device."""

    def __init__(self, cs: ContactSolver, dev):
        scene, job = cs.scene, cs.job
        sh = scene.shapes
        C = cs.num_contacts

        def index(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def boolean(a):
            return torch.as_tensor(np.asarray(a, bool), device=dev)

        sb_safe = np.maximum(job.shape_b, 0)
        self.shape_a, self.shape_b = index(job.shape_a), index(sb_safe)
        self.owner_a = index(sh.body_slot[job.shape_a])
        self.owner_b = index(sh.body_slot[sb_safe])
        self.squat_a = f32(sh.quat[job.shape_a])
        self.squat_b = f32(sh.quat[sb_safe])
        self.plane_n = f32(cs.plane_n)
        self.hf = f32(cs.hf_data) if cs.hf_data is not None else None
        if self.hf is not None:  # flat offsets of a cell's four corners
            C_hf = cs.hf_data.shape[1]
            self.hf_corner = index([0, C_hf, 1, C_hf + 1])
        self.eye3 = torch.eye(3, dtype=torch.float32, device=dev)
        self.box8 = f32(_BOX_CORNERS)
        self.ez = f32([0.0, 0.0, 1.0])

        # narrowphase: each present kind's rows (of a manifold kind, the
        # first row of each pair), its per-row constants, and the inverse
        # permutation from the kinds' concatenation to row order
        self.kinds, self.corners, self.end_sign = [], {}, {}
        # hull kinds: the vertex hull's (P, V, 3) and the plane hull's
        # (P, F, 4) table rows, and each hull's static size (P, 3), which a
        # runtime size is divided by to scale the hull
        self.hull_v, self.hull_p = {}, {}
        self.hull_v_size, self.hull_p_size = {}, {}
        if cs.hull_verts is not None:
            hull_side = {K_HULL_PLANE: ("a", None), K_HULLV_BOX: ("a", None),
                         K_BOXV_HULL: (None, "a"), K_HULLV_HULL: ("a", "b"),
                         K_HULLV_HULL_R: ("b", "a"), K_SPH_HULL: (None, "b"),
                         K_CAP_HULL: (None, "b")}
        order = []
        for code in NARROWPHASE_KINDS:
            i = np.nonzero(job.kind == code)[0]
            if code in _ROWS_OF_PAIR:
                i = i[job.slot[i] == 0]
            if not len(i):
                continue
            slot = job.slot[i]
            self.kinds.append((code, index(i)))
            if code in _ROWS_OF_PAIR:  # a pair's rows are consecutive
                order.append(np.stack([i + c for c in range(_ROWS_OF_PAIR[code])], 1).ravel())
            else:
                order.append(i)
            if code == K_PT_SDF:
                self.sdf = _SdfTables(cs, i, dev)
            if K_HULL_PLANE <= code <= K_CAP_HULL:
                v_side, p_side = hull_side[code]
                shapes = {"a": job.shape_a[i], "b": np.maximum(job.shape_b[i], 0)}
                if v_side is not None:
                    s_v = shapes[v_side]
                    self.hull_v[code] = f32(cs.hull_verts[sh.hull_id[s_v]])
                    self.hull_v_size[code] = f32(np.maximum(sh.size[s_v].astype(np.float32), 1e-6))
                if p_side is not None:
                    s_p = shapes[p_side]
                    self.hull_p[code] = f32(cs.hull_planes[sh.hull_id[s_p]])
                    self.hull_p_size[code] = f32(np.maximum(sh.size[s_p].astype(np.float32), 1e-6))
            if code in (K_CAP_PLANE, K_CAP_BOX, K_CAP_HULL):
                self.end_sign[code] = f32(np.where(slot == 0, 1.0, -1.0))
            elif code == K_BOX_PLANE:
                self.corners[code] = f32(_BOX_CORNERS[slot])
            elif code == K_BOX_BOX:
                # slots 0-7: corners of a in b; 8-15: corners of b in a
                self.corners[code] = f32(_BOX_CORNERS[np.where(slot < 8, slot, slot - 8)])
                self.bb_is_av = boolean(slot < 8)
        inv = np.empty(C, np.int64)
        inv[np.concatenate(order)] = np.arange(C)
        self.inv = index(inv)

        # solve: material, mass splitting, contact force
        self.has_b = boolean(job.shape_b >= 0)
        self.body_a, self.body_b = index(job.a.body), index(job.b.body)
        self.oh_cnt = f32((cs._oh_cnt_a + cs._oh_cnt_b).T)  # (C, B_env)
        self.oh_cf = f32(cs._oh_cf_a - cs._oh_cf_b)  # (B_env, C)
        self.kin_a = boolean(job.a.type == T_STATIC)
        self.kin_b = boolean((job.b.type == T_STATIC) & (job.shape_b >= 0))

        # entities: free bodies, then each group's copies, then the zero row
        fg = scene.free_group
        self.F = fg.count if fg is not None else 0
        self.group_row, row = [], self.F
        nv_max = 6 if self.F else 1
        for g in scene.art_groups:
            self.group_row.append(row)
            row += len(g.slots)
            nv_max = max(nv_max, g.num_dofs + (0 if g.fixed_base else 6))
        self.E, self.Dmax = row, nv_max

        ents, self.free, self.free_mask, self.links = [], [], [], []
        for s, sd in enumerate((job.a, job.b)):
            is_free = sd.type == T_FREE
            ent = np.full(C, -1, np.int64)
            ent[is_free] = sd.free[is_free]
            links = []
            for g_id, lists in enumerate(cs.link_lists):
                idx = lists[s]
                if not len(idx):
                    continue
                ent[idx] = self.group_row[g_id] + sd.copy[idx]
                links.append((g_id, index(idx), index(sd.copy[idx]), index(sd.link[idx]),
                              index(sd.body[idx])))
            self.links.append(links)
            self.free.append(index(np.where(is_free, sd.free, 0)))
            self.free_mask.append(boolean(is_free))
            ents.append(ent)
        ent_ab = np.stack(ents, 1)  # (C, 2); -1: a static side
        oh = np.zeros((self.E + 1, C, 2), np.float32)
        c_i, s_i = np.nonzero(ent_ab >= 0)
        oh[ent_ab[c_i, s_i], c_i, s_i] = 1.0
        self.oh_ent = f32(oh.reshape(self.E + 1, 2 * C))
        self.ent_ab = index(np.where(ent_ab >= 0, ent_ab, self.E))


class _SdfTables:
    """Device tensors of the SDF probe rows (one entry per pair direction q,
    in row order): the probes (Q, P, 3), each side's static size, and per
    evaluation family its q indices and data; the inverse permutation from
    the families' concatenation back to q order."""

    def __init__(self, cs: ContactSolver, i0, dev):
        sh = cs.scene.shapes
        job = cs.job

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def index(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

        self.probes = f32(cs.sdf_probes)
        self.base_a = f32(np.maximum(sh.size[job.shape_a[i0]].astype(np.float32), 1e-6))
        self.base_b = f32(np.maximum(sh.size[job.shape_b[i0]].astype(np.float32), 1e-6))
        # families: (q indices, None) for the voxel rows, (q indices, fn) per
        # closed form
        self.families, qcat = [], []
        if len(cs.sdf_voxel_q):
            qv, gid = cs.sdf_voxel_q, cs.sdf_voxel_grid
            self.families.append((index(qv), None))
            qcat.append(qv)
            R = cs.sdf_data.shape[1]
            self.data = f32(cs.sdf_data).reshape(-1)  # flat, one gather a query
            self.res = R
            self.origin = f32(cs.sdf_origin[gid])  # (Qv, 3)
            self.spacing = f32(cs.sdf_spacing[gid])
            self.grid_base = index(gid.astype(np.int64) * R ** 3)  # (Qv,)
            # flat offsets of a cell's 8 corners, (dx, dy, dz) = bits 2, 1, 0
            self.corner = index([dx * R * R + dy * R + dz
                                 for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
        for fn, qs in cs.sdf_analytic_groups:
            self.families.append((index(qs), fn))
            qcat.append(qs)
        qcat = np.concatenate(qcat)
        self.inv = None if np.array_equal(qcat, np.arange(len(i0))) else index(np.argsort(qcat))


def _sdf_narrowphase(t: _SdfTables, pa, qa, pb, qb, size_a, size_b):
    """Probe-vs-SDF contacts of the pair directions' first rows (N, Q, .):
    (point, normal, depth) of rows (N, Q * _SDF_MANIFOLD), q-major.

    All P probes of side a are pushed through side b's signed-distance
    field, scaled by both sides' runtime size over their static size (the
    field's distance by the mean of side b's, a uniform-scale
    approximation). Each family of fields is evaluated on its own q-slice:
    voxel grids by `_sdf_trilinear`, closed forms and their autograd
    gradient. Manifold selection is strided-grouped: slot m takes the
    deepest probe among {g*M + m : g} (argmin, first index on ties)."""
    M = _SDF_MANIFOLD
    sig_a = size_a / t.base_a  # (N, Q, 3) runtime scale
    sig_b = size_b / t.base_b
    w = pa[:, :, None] + quat_rotate(qa[:, :, None], t.probes[None] * sig_a[:, :, None])
    rel = quat_rotate(quat_conjugate(qb[:, :, None]), w - pb[:, :, None]) / sig_b[:, :, None].clamp_min(1e-6)
    phis, normals = [], []
    for qs, fn in t.families:
        rel_q = rel[:, qs]
        if fn is None:
            phi_q, n_q = _sdf_trilinear(t, rel_q)
        else:
            # the closed form's gradient, on a leaf of its own: a caller's
            # no_grad does not reach it, and no graph leaves the narrowphase
            r = rel_q.detach().requires_grad_(True)
            with torch.enable_grad():
                phi_q = fn(r)
                g = torch.autograd.grad(phi_q.sum(), r)[0]
            phi_q = phi_q.detach()
            n_q = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True).clamp_min(1e-9)
        phis.append(phi_q)
        normals.append(n_q)
    phi, n_loc = torch.cat(phis, 1), torch.cat(normals, 1)
    if t.inv is not None:
        phi, n_loc = phi[:, t.inv], n_loc[:, t.inv]
    phi = phi * sig_b.mean(-1)[..., None]  # uniform-scale approximation
    n_w = quat_rotate(qb[:, :, None], n_loc)
    N, Q, P = phi.shape
    G = P // M
    ti = torch.argmin(phi.reshape(N, Q, G, M), 2)  # deepest per stride (N, Q, M)
    j = ti[:, :, None]  # (N, Q, 1, M): probe ti * M + m of each slot m
    depth = -torch.gather(phi.reshape(N, Q, G, M), 2, j)
    j3 = j[..., None].expand(N, Q, 1, M, 3)
    pts = torch.gather(w.reshape(N, Q, G, M, 3), 2, j3)
    nrm = torch.gather(n_w.reshape(N, Q, G, M, 3), 2, j3)
    return pts.reshape(N, Q * M, 3), nrm.reshape(N, Q * M, 3), depth.reshape(N, Q * M)


def _sdf_trilinear(t: _SdfTables, x):
    """Trilinear SDF lookup with the exact gradient of the interpolant.

    x (N, Qv, P, 3) query points of the voxel rows in their SDF mesh's
    AABB-centered frame. Returns (phi (N, Qv, P), n (N, Qv, P, 3)). Queries
    outside the grid clamp to the border and add the clamped Euclidean
    excess, so far probes stay positive (no contact). The eight corners of
    a query's cell are one gather from the flat stacked grid."""
    org = t.origin[None, :, None]  # (1, Qv, 1, 3)
    spc = t.spacing[None, :, None]
    g = (x - org) / spc
    R = t.res
    gc = torch.minimum(torch.maximum(g, g.new_full((), 0.0)), g.new_full((), R - 1.001))
    excess = torch.linalg.vector_norm((g - gc) * spc, dim=-1)
    i0 = torch.floor(gc)
    f = gc - i0
    i0 = i0.long()
    flat = (t.grid_base[None, :, None] + (i0[..., 0] * R + i0[..., 1]) * R + i0[..., 2])
    c = t.data[flat[..., None] + t.corner]  # (N, Qv, P, 8)
    c000, c001, c010, c011, c100, c101, c110, c111 = c.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    phi = c0 * (1 - fz) + c1 * fz + excess
    dpdx = ((c100 - c000) * (1 - fy) + (c110 - c010) * fy) * (1 - fz) + (
        (c101 - c001) * (1 - fy) + (c111 - c011) * fy
    ) * fz
    dpdy = ((c010 - c000) * (1 - fx) + (c110 - c100) * fx) * (1 - fz) + (
        (c011 - c001) * (1 - fx) + (c111 - c101) * fx
    ) * fz
    dpdz = ((c001 - c000) * (1 - fx) + (c101 - c100) * fx) * (1 - fy) + (
        (c011 - c010) * (1 - fx) + (c111 - c110) * fx
    ) * fy
    grad = torch.stack([dpdx, dpdy, dpdz], -1) / spc
    n = grad / torch.linalg.vector_norm(grad, dim=-1, keepdim=True).clamp_min(1e-9)
    return phi, n


def _pair_allowed(scene, si, sj):
    sh = scene.shapes
    if sh.actor_slot[si] == sh.actor_slot[sj]:
        return False  # self-collision off within an actor's shapes
    gi, gj = sh.collision_group[si], sh.collision_group[sj]
    if not (gi == gj or gi == -1 or gj == -1):
        return False
    if (sh.collision_filter[si] & sh.collision_filter[sj]) != 0:
        return False
    return True


def _pad(x, dim, size):
    """x zero-padded at the end of axis `dim` (-1 or -2) to `size`."""
    n = size - x.shape[dim]
    if not n:
        return x
    return torch.nn.functional.pad(x, (0, n) if dim == -1 else (0, 0, 0, n))


def _segment_closest(a0, a1, b0, b1):
    """Closest points between segments, batched (..., 3)."""
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    a = (d1 * d1).sum(-1)
    e = (d2 * d2).sum(-1)
    f = (d2 * r).sum(-1)
    c = (d1 * r).sum(-1)
    b = (d1 * d2).sum(-1)
    denom = (a * e - b * b).clamp_min(1e-9)
    s = torch.clamp((b * f - c * e) / denom, 0.0, 1.0)
    t = torch.clamp((b * s + f) / e.clamp_min(1e-9), 0.0, 1.0)
    s = torch.clamp((b * t - c) / a.clamp_min(1e-9), 0.0, 1.0)
    return a0 + d1 * s[..., None], b0 + d2 * t[..., None]


def _dot(a, b):
    return (a * b).sum(-1)


def _box_box_face(pa, qa, sza, pb, qb, szb, corner, is_av, contact_offset):
    """Pair-level face-SAT manifold of box-box rows: slot rows 0-7 hold the
    corners of box a tested against box b's reference face, 8-15 the
    corners of b against a's. Per-vertex minimum-penetration axes would
    break exactly aligned stacks, so every row of a pair uses the pair's
    reference face (the face axis of least separation). `corner` (P, 3) is
    each row's corner, `is_av` (P,) whether it is a corner of a."""
    Ra = quat_to_matrix(qa)  # (N, P, 3, 3) columns = axes
    Rb = quat_to_matrix(qb)
    d_ab = pb - pa
    big = 1e9

    def face_sat(R_ref):
        bs = torch.full(pa.shape[:-1], -big, dtype=pa.dtype, device=pa.device)
        bn = torch.zeros_like(pa)
        bk = torch.zeros(pa.shape[:-1], dtype=torch.long, device=pa.device)
        for k in range(3):
            ax = R_ref[..., :, k]
            proj_a = sum(_dot(ax, Ra[..., :, q]).abs() * sza[..., q] for q in range(3))
            proj_b = sum(_dot(ax, Rb[..., :, q]).abs() * szb[..., q] for q in range(3))
            dist = _dot(ax, d_ab)
            sep = dist.abs() - (proj_a + proj_b)
            better = sep > bs
            bs = torch.where(better, sep, bs)
            n_dir = ax * torch.where(dist > 0, -1.0, 1.0)[..., None]
            bn = torch.where(better[..., None], n_dir, bn)
            bk = torch.where(better, k, bk)
        return bs, bn, bk

    sep_fa, n_fa, k_fa = face_sat(Ra)
    sep_fb, n_fb, k_fb = face_sat(Rb)
    face_best = torch.maximum(sep_fa, sep_fb)

    va_w = pa + quat_rotate(qa, corner * sza)
    vb_w = pb + quat_rotate(qb, corner * szb)
    av = is_av[..., None]
    vtx_w = torch.where(av, va_w, vb_w)
    ref_p = torch.where(av, pb, pa)
    ref_q = torch.where(av, qb, qa)
    ref_size = torch.where(av, szb, sza)
    ref_k = torch.where(is_av, k_fb, k_fa)
    ref_n = torch.where(av, n_fb, n_fa)
    ref_sep = torch.where(is_av, sep_fb, sep_fa)
    incident = ref_sep >= face_best - 1e-5
    rel = quat_rotate(quat_conjugate(ref_q), vtx_w - ref_p)
    pen_ax = ref_size - rel.abs()  # (N, P, 3)
    dep_face = torch.gather(pen_ax, -1, ref_k[..., None])[..., 0]
    n_within = (pen_ax > -contact_offset).sum(-1)
    lat_ok = (n_within - (dep_face > -contact_offset).long()) >= 2
    depth = torch.where(incident & lat_ok, dep_face, -1.0)
    return vtx_w, ref_n, depth


def _box_box_edge(pa, qa, size_a, pb, qb, size_b):
    """Deepest edge-edge contact between two OBBs (one candidate per pair).

    SAT over the 9 edge-cross axes; the winning axis pair's closest edge
    points give the contact. Catches the corner-on-corner / 45-degree
    stacking cases vertex-in-box misses (the reference's
    examples/large_mass_ratio.py:110-114)."""
    Ra = quat_to_matrix(qa)  # (N, C, 3, 3) columns = axes
    Rb = quat_to_matrix(qb)
    d = pb - pa
    big = 1e9

    def proj(axis_n, R, size):
        return sum(_dot(axis_n, R[..., :, k]).abs() * size[..., k] for k in range(3))

    # face-axis separations (6): the edge contact only fires when an edge
    # cross axis is the MINIMUM-penetration (max separation) axis — else the
    # vertex-in-box contacts own the manifold (plain SAT axis selection)
    face_sep = torch.full(pa.shape[:-1], -big, dtype=pa.dtype, device=pa.device)
    for R in (Ra, Rb):
        for k in range(3):
            axis_n = R[..., :, k]
            sep = _dot(axis_n, d).abs() - (proj(axis_n, Ra, size_a) + proj(axis_n, Rb, size_b))
            face_sep = torch.maximum(face_sep, sep)

    best_sep = torch.full(pa.shape[:-1], -big, dtype=pa.dtype, device=pa.device)
    best_axis = torch.zeros_like(pa)
    best_i = torch.zeros(pa.shape[:-1], dtype=torch.long, device=pa.device)
    best_j = torch.zeros(pa.shape[:-1], dtype=torch.long, device=pa.device)
    for i in range(3):
        for j in range(3):
            axis = cross(Ra[..., :, i], Rb[..., :, j])
            ln = torch.linalg.vector_norm(axis, dim=-1)
            # near-parallel edges give garbage directions when normalized;
            # their contacts are face-like and owned by the vertex manifold
            ok = ln > 5e-2
            axis_n = axis / ln.clamp_min(1e-9)[..., None]
            dist = _dot(axis_n, d)
            sep = dist.abs() - (proj(axis_n, Ra, size_a) + proj(axis_n, Rb, size_b))
            sep = torch.where(ok, sep, -big)  # negative = overlap on this axis
            better = sep > best_sep
            best_sep = torch.where(better, sep, best_sep)
            # axis oriented b -> a
            sgn = torch.where(dist > 0, -1.0, 1.0)
            best_axis = torch.where(better[..., None], axis_n * sgn[..., None], best_axis)
            best_i = torch.where(better, i, best_i)
            best_j = torch.where(better, j, best_j)

    def support_edge(R, size, center, axis_out, edir_idx):
        """Edge most along axis_out, excluding the edge direction axis."""
        corner = torch.zeros_like(center)
        for k in range(3):
            ak = R[..., :, k]
            s = torch.sign(_dot(ak, axis_out))
            s = torch.where(s == 0, 1.0, s)
            use = edir_idx != k
            corner = corner + torch.where(use[..., None], ak * (s * size[..., k])[..., None], 0.0)
        Rt = R.transpose(-1, -2)  # (..., 3 axes, 3 components)
        edir = torch.gather(Rt, -2, edir_idx[..., None, None].expand(Rt.shape[:-2] + (1, 3)))[..., 0, :]
        half = torch.gather(size, -1, edir_idx[..., None])[..., 0]
        p0 = center + corner - edir * half[..., None]
        p1 = center + corner + edir * half[..., None]
        return p0, p1

    a0, a1 = support_edge(Ra, size_a, pa, -best_axis, best_i)
    b0, b1 = support_edge(Rb, size_b, pb, best_axis, best_j)
    pA, pB = _segment_closest(a0, a1, b0, b1)
    point = 0.5 * (pA + pB)
    # fire only when the boxes genuinely overlap (every SAT axis overlaps)
    # AND an edge axis is the minimum-penetration one
    overlap = torch.maximum(best_sep, face_sep) < 0
    # ties go to the vertex manifold (stability under sliding face contact)
    use_edge = best_sep > face_sep + 1e-4
    depth = torch.where(overlap & use_edge, -best_sep, -1.0)
    return point, best_axis, depth


def _hull_planes(verts: np.ndarray) -> np.ndarray:
    """Outward face planes [n, d] (n.x + d <= 0 inside) of a convex vertex
    set, near-identical faces merged (their order is np.unique's). Falls
    back to the 6 AABB planes if qhull rejects the input (degenerate or
    flat hulls)."""
    try:
        from scipy.spatial import ConvexHull

        eq = ConvexHull(np.asarray(verts, np.float64)).equations
        eq = np.unique(np.round(eq, 6), axis=0)
        return eq.astype(np.float32)
    except Exception:
        lo, hi = verts.min(0), verts.max(0)
        eq = []
        for k in range(3):
            n = np.zeros(3)
            n[k] = 1.0
            eq.append(np.concatenate([n, [-hi[k]]]))
            eq.append(np.concatenate([-n, [lo[k]]]))
        return np.asarray(eq, np.float32)


def _heightfield_sdf(data, hscale, offset, p, corner):
    """Approximate signed distance and normal of points p (..., 3) above a
    heightfield data (R, C) in meters: bilinear height, analytic patch
    gradient. Beyond the grid the terrain extends flat at the edge height,
    so the gradient is zero there. `corner` holds the flat offsets [0, C, 1,
    C + 1] of a cell's corners (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1),
    read in one gather."""
    R, C = data.shape
    x_raw = (p[..., 0] - offset[0]) / hscale
    y_raw = (p[..., 1] - offset[1]) / hscale
    x = torch.clamp(x_raw, 0.0, R - 1 - 1e-4)
    y = torch.clamp(y_raw, 0.0, C - 1 - 1e-4)
    in_x = (x_raw >= 0.0) & (x_raw <= R - 1)
    in_y = (y_raw >= 0.0) & (y_raw <= C - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = (x0.long() * C + y0.long())[..., None] + corner
    h00, h10, h01, h11 = data.reshape(-1)[flat].unbind(-1)
    h = (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
         + h01 * (1 - fx) * fy + h11 * fx * fy)
    gx = torch.where(in_x, ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / hscale, 0.0)
    gy = torch.where(in_y, ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / hscale, 0.0)
    inv_len = 1.0 / torch.sqrt(1.0 + gx * gx + gy * gy)
    normal = torch.stack([-gx, -gy, torch.ones_like(gx)], -1) * inv_len[..., None]
    return (p[..., 2] - h) * inv_len, normal

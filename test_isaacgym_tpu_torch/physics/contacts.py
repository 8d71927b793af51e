"""Contact generation and batched impulse solver.

Port of test_isaacgym_tpu/physics/contacts.py, so far the part the
sphere-world path runs:
  * `ContactSolver.__init__` builds the same collidable entities, fast-path
    specs and static candidate-contact row table as the JAX package, for any
    scene;
  * `ContactSolver.solve` runs the dense sphere-world fast path
    (ops/sphere_world.py) and returns.
Narrowphase and the static-table Jacobi solve, link (articulation) sides,
hulls, heightfields, SDF probes and the neighbor-list solve are later slices
of the port: a scene that needs them raises NotImplementedError (a non-empty
row table at Stepper construction, a neighbor-world spec in `solve`).

Each contact side is one of
  FREE   — free rigid body: responds via (1/m, I^-1) impulses,
  LINK   — articulation link: responds via joint-space impulses,
  STATIC — world geometry: kinematic, no response.

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

_MANIFOLD = 4  # contact manifold size for hull vertex kinds
_SDF_MANIFOLD = 16  # manifold size for SDF probe kinds


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


# most shape pairs the static contact table takes (the JAX package's limit)
MAX_PAIR_SHAPES = 4096


class ContactSolver:
    def __init__(self, scene: Scene):
        self.scene = scene
        self.enabled = False
        self._sw_dev = None  # sphere_world spec, index tensors on one device
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
        if len(pairs) > MAX_PAIR_SHAPES:
            raise ValueError(
                f"{len(pairs)} static contact pairs exceeds MAX_PAIR_SHAPES="
                f"{MAX_PAIR_SHAPES}. Large free-body worlds take the dense "
                "fast paths automatically (pure spheres: ops/sphere_world; "
                "mixed sphere/box single-shape actors: ops/neighbor_world) — "
                "this scene's pairs involve articulated links, multi-shape "
                "actors, or meshes at a scale the static table can't hold."
            )
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

    # ------------------------------------------------------------------
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

    # ------------------------------------------------------------------
    def solve(self, body_pos, free_v, free_w, free_m, free_I_w, params, h):
        """Velocity-level contact solve of the free bodies.

        body_pos: CURRENT positions of every env body (N, B, 3);
        free_v/free_w/free_m/free_I_w: the free-body batch's velocities,
        masses and world inertias.
        Returns (free_v, free_w, contact_force (N, B, 3))."""
        from ..ops import sphere_world as _sw

        N = body_pos.shape[0]
        B_env = self.scene.num_bodies_per_env
        cf = torch.zeros((N, B_env, 3), dtype=body_pos.dtype, device=body_pos.device)
        if not self.enabled:
            return free_v, free_w, cf
        if self.sphere_world is not None:
            args = self._sphere_world_inputs(
                body_pos, free_v, free_w, free_m, free_I_w, params, h
            )
            _, fidx, _, bidx = self._sphere_world_on(body_pos.device)
            v1, w1, cf_s = _sw.solve(*args)
            free_v = free_v.index_copy(1, fidx, v1)
            free_w = free_w.index_copy(1, fidx, w1)
            cf = cf.index_add(1, bidx, cf_s)
        if self.neighbor_world is not None:
            raise NotImplementedError(
                "the neighbor-list contact solve (ops/neighbor_world.py) is "
                "not ported to the torch package yet"
            )
        if self.num_contacts:
            raise NotImplementedError(
                "narrowphase and the static contact-table solve are not ported "
                "to the torch package yet"
            )
        return free_v, free_w, cf


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

"""Object piles on a ground plane or on terrain: the scenes of the hull and
terrain paths.

  * hull_pile: the objects of the reference's examples/kuka_bin.py dropped
    in a column in every env, on a ground plane, with its SimParams (dt
    1/60, 2 substeps, 8 position iterations, kuka_bin.py:19-20). The YCB
    meshes are not in the repository, so the objects are made in code at
    their sizes: the example's 0.045 m cube, a 16-gon prism "can" (r 0.033
    m, h 0.10 m) and an irregular hull of 48 seeded points on a (0.09,
    0.02, 0.018) m ellipsoid (the banana's size), both through
    `create_mesh_asset`, a sphere of r 0.03 m and a capsule of r 0.02 m,
    half length 0.04 m. Every convex-hull contact kind (10-16) occurs.
  * terrain: the same five objects over the terrain map of IsaacGymEnvs'
    AnymalTerrain task (isaacgymenvs/cfg/task/AnymalTerrain.yaml;
    isaacgymenvs/utils/terrain.py `Terrain.curiculum`): 10 levels x 20
    terrain types of 8 m tiles at 0.1 m x 0.005 m, a 20 m border, a
    1200 x 2000 heightfield; pyramid slopes, rough slopes, stairs up and
    down and discrete obstacles in proportions 0.1 / 0.1 / 0.35 / 0.25 /
    0.2, difficulty rising by level.

The builders take the package's modules as arguments (`prim`: an
assets.primitives module; `builder`: a SceneBuilder), so one definition
builds the same scene in this package and, in the tests, in the JAX one.
Every random draw comes from a numpy seed.
"""
from __future__ import annotations

import numpy as np

from .. import terrain_utils as tu

# the env cell of hull_pile (one object column an env) and of terrain
# (create_env((-1.25, -0.625, 0), (1.25, 0.625, 1), 32): 4096 envs cover
# the 80 m x 160 m inner map)
PILE_CELL, PILE_PER_ROW = ((-0.5, -0.5, 0.0), (0.5, 0.5, 1.0)), 64
TERRAIN_CELL, TERRAIN_PER_ROW = ((-1.25, -0.625, 0.0), (1.25, 0.625, 1.0)), 32
# heights of the object column above the ground (hull_pile), or above the
# terrain at the env origin plus TERRAIN_DROP (terrain)
COLUMN_Z = (0.10, 0.20, 0.30, 0.40, 0.50)
TERRAIN_DROP = 0.4  # the column's lowest object 0.5 m above the terrain
JITTER = 0.01  # m, uniform in x and y
# AnymalTerrain.yaml
TERRAIN_PROPORTIONS = (0.1, 0.1, 0.35, 0.25, 0.2)
LEVELS, TERRAIN_TYPES, TILE, BORDER = 10, 20, 8.0, 20.0
H_SCALE, V_SCALE = 0.1, 0.005


def can_mesh(radius=0.033, height=0.10, sides=16):
    """(vertices, faces) of a closed 16-gon prism centred on the origin."""
    a = 2 * np.pi * np.arange(sides) / sides
    ring = np.stack([radius * np.cos(a), radius * np.sin(a)], -1)
    verts = np.concatenate([np.c_[ring, np.full(sides, -height / 2)],
                            np.c_[ring, np.full(sides, height / 2)]]).astype(np.float32)
    k = np.arange(sides)
    k1 = (k + 1) % sides
    sides_f = np.concatenate([np.stack([k, k1, k1 + sides], -1),
                              np.stack([k, k1 + sides, k + sides], -1)])
    fan = np.arange(1, sides - 1)
    caps = np.concatenate([np.stack([np.zeros_like(fan), fan + 1, fan], -1),
                           np.stack([np.full_like(fan, sides), fan + sides, fan + 1 + sides], -1)])
    return verts, np.concatenate([sides_f, caps]).astype(np.int32)


def banana_mesh(seed=11, n=48, axes=(0.09, 0.02, 0.018)):
    """(vertices, faces) of an irregular convex solid: n seeded points on an
    ellipsoid of semi-axes `axes`, faced by their convex hull."""
    from scipy.spatial import ConvexHull

    d = np.random.RandomState(seed).normal(size=(n, 3))
    verts = (d / np.linalg.norm(d, axis=1, keepdims=True) * np.asarray(axes)).astype(np.float32)
    return verts, ConvexHull(verts.astype(np.float64)).simplices.astype(np.int32)


def pile_assets(prim):
    """The five objects, built by the primitives module `prim`: cube, can,
    banana, sphere, capsule (free bodies, density 1000)."""
    return [
        prim.create_box(0.045, 0.045, 0.045),
        prim.create_mesh_asset("can", *can_mesh()),
        prim.create_mesh_asset("banana", *banana_mesh()),
        prim.create_sphere(0.03),
        prim.create_capsule(0.02, 0.04),
    ]


def pile_params(config):
    """kuka_bin.py's SimParams: the defaults (dt 1/60, 2 substeps) with 8
    position iterations."""
    sp = config.SimParams(dt=1 / 60, substeps=2)
    sp.physx.num_position_iterations = 8
    return sp


def anymal_terrain(seed=42):
    """The AnymalTerrain map: (height_field_raw int16 (1200, 2000),
    horizontal scale, vertical scale, border in m). Rows run along x
    (levels), columns along y (terrain types), as in `Terrain.curiculum`.
    Draws from numpy's global generator, seeded here."""
    np.random.seed(seed)
    px = int(TILE / H_SCALE)
    border = int(BORDER / H_SCALE)
    raw = np.zeros((LEVELS * px + 2 * border, TERRAIN_TYPES * px + 2 * border), np.int16)
    props = np.cumsum(TERRAIN_PROPORTIONS)
    for j in range(TERRAIN_TYPES):
        for i in range(LEVELS):
            t = tu.SubTerrain("terrain", width=px, length=px, vertical_scale=V_SCALE,
                              horizontal_scale=H_SCALE)
            difficulty, choice = i / LEVELS, j / TERRAIN_TYPES
            slope = difficulty * 0.4
            step_height = 0.05 + 0.175 * difficulty
            obstacle_height = 0.025 + difficulty * 0.15
            if choice < props[0]:
                if choice < 0.05:
                    slope *= -1
                tu.pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
            elif choice < props[1]:
                if choice < 0.15:
                    slope *= -1
                tu.pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
                tu.random_uniform_terrain(t, min_height=-0.1, max_height=0.1, step=0.025,
                                          downsampled_scale=0.2)
            elif choice < props[3]:
                if choice < props[2]:
                    step_height *= -1
                tu.pyramid_stairs_terrain(t, step_width=0.31, step_height=step_height,
                                          platform_size=3.0)
            else:
                tu.discrete_obstacles_terrain(t, obstacle_height, 1.0, 2.0, 40, platform_size=3.0)
            raw[border + i * px:border + (i + 1) * px,
                border + j * px:border + (j + 1) * px] = t.height_field_raw
    return raw, H_SCALE, V_SCALE, BORDER


def grid_origin(k, cell, per_row):
    """The origin SceneBuilder.create_env gives the k-th env of a grid."""
    ext = np.asarray(cell[1], np.float64) - np.asarray(cell[0], np.float64)
    row, col = divmod(k, per_row)
    return np.array([col * ext[0], row * ext[1], 0.0])


def terrain_range(heights, hscale, offset, xy, reach=0.2):
    """(lowest, highest) terrain (m) within `reach` m of each point xy
    (..., 2) of a heightfield `heights` (m) of cells `hscale` m apart whose
    cell (0, 0) lies at `offset` on both axes (cells off the map read as
    its edge)."""
    r = int(np.ceil(reach / hscale))
    i = np.rint((xy[..., 0] - offset) / hscale).astype(int)
    j = np.rint((xy[..., 1] - offset) / hscale).astype(int)
    lo, hi = np.full(i.shape, np.inf), np.full(i.shape, -np.inf)
    for di in range(-r, r + 1):
        for dj in range(-r, r + 1):
            h = heights[np.clip(i + di, 0, heights.shape[0] - 1),
                        np.clip(j + dj, 0, heights.shape[1] - 1)]
            lo, hi = np.minimum(lo, h), np.maximum(hi, h)
    return lo, hi


def terrain_clearance(heights, hscale, offset, pos, reach=0.1):
    """(lowest height of an object centre above the lowest terrain within
    `reach` m of it, highest height of one above the highest terrain
    there) over root positions pos (..., 3): on stairs and obstacles the
    nearest cell can be the other side of a step from where an object
    rests, so each bound reads the side of the step that favours it."""
    pos = np.asarray(pos).reshape(-1, 3)
    lo, hi = terrain_range(heights, hscale, offset, pos[:, :2], reach)
    return float((pos[:, 2] - lo).min()), float((pos[:, 2] - hi).max())


def build(builder, config, assets, env_ids, terrain=None, seed=0):
    """Fill `builder` (a SceneBuilder of `config`'s package) with the envs
    `env_ids` of a pile grid: a ground plane, or with `terrain` (from
    anymal_terrain) the heightfield offset so that the inner map starts at
    the grid's origin. Env k of the grid gets the column of `assets` at its
    grid origin, whichever index it has in this build, with the jitter and
    yaw drawn for k from RandomState(seed): a build of a few envs of the grid
    places them where the full build does."""
    env_ids = list(env_ids)
    n_grid = max(env_ids) + 1
    rng = np.random.RandomState(seed)
    jitter = rng.uniform(-JITTER, JITTER, (n_grid, len(assets), 2))
    yaw = rng.uniform(-np.pi, np.pi, (n_grid, len(assets)))
    if terrain is None:
        builder.add_ground(config.PlaneParams())
        cell, per_row = PILE_CELL, PILE_PER_ROW
    else:
        raw, hs, vs, border = terrain
        builder.add_heightfield(raw, hs, vs, -border, -border)
        cell, per_row = TERRAIN_CELL, TERRAIN_PER_ROW
        heights = raw.astype(np.float32) * np.float32(vs)
    for slot, k in enumerate(env_ids):
        builder.create_env(cell[0], cell[1], per_row)
        shift = grid_origin(k, cell, per_row) - grid_origin(slot, cell, per_row)
        base = 0.0
        if terrain is not None:
            base = float(terrain_range(heights, hs, -border, grid_origin(k, cell, per_row)[:2])[1])
            base += TERRAIN_DROP
        for a, (asset, z) in enumerate(zip(assets, COLUMN_Z)):
            pos = shift + np.array([jitter[k, a, 0], jitter[k, a, 1], base + z])
            half = 0.5 * yaw[k, a]
            builder.create_actor(slot, asset, pos=tuple(pos),
                                 quat=(0.0, 0.0, float(np.sin(half)), float(np.cos(half))),
                                 name=f"obj{a}", group=slot, filter=0)
    return builder


def ground_clearance(contact, depth):
    """Each env's lowest clearance (N,) of any object above the ground or
    terrain: minus the largest depth of its ground rows (a sphere's r -
    height, a box corner's or a hull vertex's minus height)."""
    rows = np.nonzero(contact.job.shape_b < 0)[0]
    return -depth[:, rows].max(1)

"""`isaacgym.terrain_utils` equivalent: procedural heightfield generators.

Port of test_isaacgym_tpu/terrain_utils.py (numpy only, the same code): the
8 generators of the reference's examples/terrain_creation.py:99-119 over a
`SubTerrain` (int16 heightfield raw = meters / vertical_scale), plus
`convert_heightfield_to_trimesh`. The terrain stays a heightfield for
contact (physics/contacts.py::_heightfield_sdf); the trimesh is for the
add_triangle_mesh path (core/scene.py::add_trimesh_as_heightfield).

The generators' random layouts are seeded numpy and deterministic, but not
bit-identical to NVIDIA's.
"""
from __future__ import annotations

import numpy as np


class SubTerrain:
    def __init__(
        self,
        terrain_name: str = "terrain",
        width: int = 128,
        length: int = 128,
        vertical_scale: float = 0.005,
        horizontal_scale: float = 0.1,
    ):
        self.terrain_name = terrain_name
        self.width = width
        self.length = length
        self.vertical_scale = vertical_scale
        self.horizontal_scale = horizontal_scale
        self.height_field_raw = np.zeros((width, length), dtype=np.int16)


def random_uniform_terrain(
    terrain: SubTerrain,
    min_height: float,
    max_height: float,
    step: float = 1.0,
    downsampled_scale: float = None,
) -> SubTerrain:
    """Uniform noise quantized to `step`, generated at `downsampled_scale`
    resolution and bilinearly upsampled."""
    if downsampled_scale is None:
        downsampled_scale = terrain.horizontal_scale
    hmin = int(min_height / terrain.vertical_scale)
    hmax = int(max_height / terrain.vertical_scale)
    hstep = max(int(step / terrain.vertical_scale), 1)
    levels = np.arange(hmin, hmax + hstep, hstep)
    dw = max(int(terrain.width * terrain.horizontal_scale / downsampled_scale), 2)
    dl = max(int(terrain.length * terrain.horizontal_scale / downsampled_scale), 2)
    coarse = np.random.choice(levels, (dw, dl)).astype(np.float64)
    # bilinear upsample to (width, length)
    xi = np.linspace(0, dw - 1, terrain.width)
    yi = np.linspace(0, dl - 1, terrain.length)
    x0 = np.floor(xi).astype(int)
    y0 = np.floor(yi).astype(int)
    x1 = np.minimum(x0 + 1, dw - 1)
    y1 = np.minimum(y0 + 1, dl - 1)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    up = (
        coarse[np.ix_(x0, y0)] * (1 - fx) * (1 - fy)
        + coarse[np.ix_(x1, y0)] * fx * (1 - fy)
        + coarse[np.ix_(x0, y1)] * (1 - fx) * fy
        + coarse[np.ix_(x1, y1)] * fx * fy
    )
    terrain.height_field_raw += up.astype(np.int16)
    return terrain


def sloped_terrain(terrain: SubTerrain, slope: float = 1.0) -> SubTerrain:
    x = np.arange(terrain.width)
    max_h = int(slope * terrain.horizontal_scale / terrain.vertical_scale * terrain.width)
    terrain.height_field_raw += (
        (x * max_h / terrain.width)[:, None].astype(np.int16)
    )
    return terrain


def pyramid_sloped_terrain(
    terrain: SubTerrain, slope: float = 1.0, platform_size: float = 1.0
) -> SubTerrain:
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    cx, cy = terrain.width / 2, terrain.length / 2
    xx = (cx - np.abs(cx - x))[:, None] / cx
    yy = (cy - np.abs(cy - y))[None, :] / cy
    max_h = int(
        slope * terrain.horizontal_scale / terrain.vertical_scale * (terrain.width / 2)
    )
    hf = max_h * np.minimum(xx, yy)
    # flat platform in the middle
    ps = int(platform_size / terrain.horizontal_scale / 2)
    if ps > 0:
        x0, x1 = int(cx) - ps, int(cx) + ps
        y0, y1 = int(cy) - ps, int(cy) + ps
        cap = hf[int(cx), int(cy)]
        hf[x0:x1, y0:y1] = cap
    terrain.height_field_raw += hf.astype(np.int16)
    return terrain


def discrete_obstacles_terrain(
    terrain: SubTerrain,
    max_height: float,
    min_size: float,
    max_size: float,
    num_rects: int,
    platform_size: float = 1.0,
) -> SubTerrain:
    hmax = int(max_height / terrain.vertical_scale)
    smin = max(int(min_size / terrain.horizontal_scale), 1)
    smax = max(int(max_size / terrain.horizontal_scale), smin + 1)
    heights = np.array([-hmax, -hmax // 2, hmax // 2, hmax])
    for _ in range(num_rects):
        w = np.random.randint(smin, smax)
        l = np.random.randint(smin, smax)
        x = np.random.randint(0, max(terrain.width - w, 1))
        y = np.random.randint(0, max(terrain.length - l, 1))
        terrain.height_field_raw[x : x + w, y : y + l] = np.random.choice(heights)
    ps = int(platform_size / terrain.horizontal_scale / 2)
    if ps > 0:
        cx, cy = terrain.width // 2, terrain.length // 2
        terrain.height_field_raw[cx - ps : cx + ps, cy - ps : cy + ps] = 0
    return terrain


def wave_terrain(
    terrain: SubTerrain, num_waves: float = 1.0, amplitude: float = 1.0
) -> SubTerrain:
    amp = amplitude / (2 * terrain.vertical_scale)
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    div = terrain.length / (num_waves * 2 * np.pi)
    hf = amp * (
        np.cos(y[None, :] / div) + np.sin(x[:, None] / div)
    )
    terrain.height_field_raw += hf.astype(np.int16)
    return terrain


def stairs_terrain(
    terrain: SubTerrain, step_width: float, step_height: float
) -> SubTerrain:
    sw = max(int(step_width / terrain.horizontal_scale), 1)
    sh = int(step_height / terrain.vertical_scale)
    steps = np.arange(terrain.width) // sw
    terrain.height_field_raw += (steps * sh)[:, None].astype(np.int16)
    return terrain


def pyramid_stairs_terrain(
    terrain: SubTerrain,
    step_width: float,
    step_height: float,
    platform_size: float = 1.0,
) -> SubTerrain:
    sw = max(int(step_width / terrain.horizontal_scale), 1)
    sh = int(step_height / terrain.vertical_scale)
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    dx = np.minimum(x, terrain.width - 1 - x)[:, None]
    dy = np.minimum(y, terrain.length - 1 - y)[None, :]
    ring = np.minimum(dx, dy) // sw
    ps_rings = int(platform_size / terrain.horizontal_scale / 2 / sw)
    max_ring = int(np.min([terrain.width, terrain.length]) // 2 // sw) - ps_rings
    ring = np.minimum(ring, max(max_ring, 0))
    terrain.height_field_raw += (ring * sh).astype(np.int16)
    return terrain


def stepping_stones_terrain(
    terrain: SubTerrain,
    stone_size: float,
    stone_distance: float,
    max_height: float,
    platform_size: float = 1.0,
    depth: float = -10.0,
) -> SubTerrain:
    ss = max(int(stone_size / terrain.horizontal_scale), 1)
    sd = max(int(stone_distance / terrain.horizontal_scale), 0)
    hmax = int(max_height / terrain.vertical_scale)
    pit = int(depth / terrain.vertical_scale)
    hf = np.full((terrain.width, terrain.length), pit, np.int32)
    period = ss + sd
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    on_x = (x % period) < ss
    on_y = (y % period) < ss
    stones = on_x[:, None] & on_y[None, :]
    # per-stone random height
    nsx = terrain.width // period + 1
    nsy = terrain.length // period + 1
    stone_h = np.random.randint(-hmax, hmax + 1, (nsx, nsy))
    hf_sel = stone_h[(x // period)[:, None], (y // period)[None, :]]
    hf = np.where(stones, hf_sel, hf)
    ps = int(platform_size / terrain.horizontal_scale / 2)
    if ps > 0:
        cx, cy = terrain.width // 2, terrain.length // 2
        hf[cx - ps : cx + ps, cy - ps : cy + ps] = 0
    terrain.height_field_raw[:] = hf.astype(np.int16)
    return terrain


def convert_heightfield_to_trimesh(
    height_field_raw: np.ndarray,
    horizontal_scale: float,
    vertical_scale: float,
    slope_threshold: float = None,
):
    """Heightfield -> (vertices (V,3) f32, triangles (T,3) u32). The optional
    slope_threshold steepens walls into near-vertical faces like the
    reference's corrected meshes (walls moved toward the upper cell)."""
    hf = height_field_raw.astype(np.float64)
    rows, cols = hf.shape
    y = np.linspace(0, (cols - 1) * horizontal_scale, cols)
    x = np.linspace(0, (rows - 1) * horizontal_scale, rows)
    yy, xx = np.meshgrid(y, x)

    if slope_threshold is not None:
        slope_threshold *= horizontal_scale / vertical_scale
        move_x = np.zeros((rows, cols))
        move_y = np.zeros((rows, cols))
        move_corners = np.zeros((rows, cols))
        move_x[: rows - 1, :] += hf[1:, :] - hf[: rows - 1, :] > slope_threshold
        move_x[1:, :] -= hf[: rows - 1, :] - hf[1:, :] > slope_threshold
        move_y[:, : cols - 1] += hf[:, 1:] - hf[:, : cols - 1] > slope_threshold
        move_y[:, 1:] -= hf[:, : cols - 1] - hf[:, 1:] > slope_threshold
        move_corners[: rows - 1, : cols - 1] += (
            hf[1:, 1:] - hf[: rows - 1, : cols - 1] > slope_threshold
        )
        move_corners[1:, 1:] -= (
            hf[: rows - 1, : cols - 1] - hf[1:, 1:] > slope_threshold
        )
        xx += (move_x + move_corners * (move_x == 0)) * horizontal_scale
        yy += (move_y + move_corners * (move_y == 0)) * horizontal_scale

    vertices = np.zeros((rows * cols, 3), np.float32)
    vertices[:, 0] = xx.flatten()
    vertices[:, 1] = yy.flatten()
    vertices[:, 2] = hf.flatten() * vertical_scale

    triangles = np.zeros((2 * (rows - 1) * (cols - 1), 3), np.uint32)
    t = 0
    ind0 = np.arange(0, cols - 1)
    for i in range(rows - 1):
        base = i * cols
        v0 = base + ind0
        v1 = v0 + 1
        v2 = v0 + cols
        v3 = v2 + 1
        triangles[t : t + cols - 1] = np.stack([v0, v3, v1], -1)
        triangles[t + cols - 1 : t + 2 * (cols - 1)] = np.stack([v0, v2, v3], -1)
        t += 2 * (cols - 1)
    return vertices, triangles

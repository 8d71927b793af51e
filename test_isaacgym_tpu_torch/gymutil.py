"""`gymutil` equivalent: standard CLI flags + wireframe debug geometry.

Port of test_isaacgym_tpu/gymutil.py (numpy only, copied). The flag
inventory follows the reference's examples/1080_balls_of_solitude.py:33-38
and graphics.py:36-39. Engine flags are accepted for script parity; both
engines run the same pipeline. `--sim_device` defaults to "cuda:0", where
the port's create_sim runs.
"""
from __future__ import annotations

import argparse
import math
from typing import List, Optional

import numpy as np

from .core.config import SIM_FLEX, SIM_PHYSX


def parse_arguments(
    description: str = "TPU sim",
    headless: bool = False,
    no_graphics: bool = False,
    custom_parameters: Optional[List[dict]] = None,
    args=None,
):
    """Reference-compatible parse_arguments: returns a namespace with
    physics_engine/use_gpu/use_gpu_pipeline/num_threads/sim_device/
    compute_device_id/graphics_device_id (+ custom params)."""
    p = argparse.ArgumentParser(description=description)
    if headless:
        p.add_argument("--headless", action="store_true", default=True)
    p.add_argument("--sim_device", type=str, default="cuda:0")
    p.add_argument("--pipeline", type=str, default="gpu")
    p.add_argument("--graphics_device_id", type=int, default=0)
    p.add_argument("--flex", action="store_true")
    p.add_argument("--physx", action="store_true")
    p.add_argument("--num_threads", type=int, default=0)
    p.add_argument("--subscenes", type=int, default=0)
    p.add_argument("--slices", type=int, default=None)
    for param in custom_parameters or []:
        name = param["name"]
        kw = {k: v for k, v in param.items() if k not in ("name",)}
        p.add_argument(name, **kw)
    ns = p.parse_args(args=args)
    ns.physics_engine = SIM_FLEX if ns.flex else SIM_PHYSX
    ns.use_gpu_pipeline = ns.pipeline.lower() in ("gpu", "cuda")
    dev = ns.sim_device.split(":")
    ns.sim_device_type = dev[0]
    ns.compute_device_id = int(dev[1]) if len(dev) > 1 else 0
    ns.use_gpu = ns.sim_device_type in ("cuda", "gpu", "tpu")
    return ns


class LineGeometry:
    """Base for wireframe debug geometry: verts() (M,2) of Vec3-dtype segment
    endpoints + colors() (M,) — drawn with draw_lines
    (the reference's test/test01_isaacgym_asset.py:218-219)."""

    def verts(self):
        return self._verts

    def colors(self):
        return self._colors

    @property
    def num_lines(self):
        return len(self._verts)


def _seg_array(segs, color):
    from .assets.types import VEC3_DTYPE

    n = len(segs)
    v = np.zeros((n, 2), VEC3_DTYPE)
    c = np.zeros(n, VEC3_DTYPE)
    for i, (a, b) in enumerate(segs):
        v[i][0] = tuple(a)
        v[i][1] = tuple(b)
        c[i] = tuple(color[i] if isinstance(color, list) else color)
    return v, c


class AxesGeometry(LineGeometry):
    def __init__(self, scale: float = 1.0, pose=None):
        segs = [
            ((0, 0, 0), (scale, 0, 0)),
            ((0, 0, 0), (0, scale, 0)),
            ((0, 0, 0), (0, 0, scale)),
        ]
        if pose is not None:
            segs = [
                (_xform(pose, a), _xform(pose, b)) for a, b in segs
            ]
        self._verts, self._colors = _seg_array(
            segs, [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
        )


class WireframeSphereGeometry(LineGeometry):
    def __init__(self, radius=1.0, num_lats=8, num_lons=8, pose=None, color=(1, 0, 0)):
        segs = []
        for i in range(num_lats):
            t0 = math.pi * i / num_lats
            t1 = math.pi * (i + 1) / num_lats
            for j in range(num_lons):
                p0 = 2 * math.pi * j / num_lons
                p1 = 2 * math.pi * (j + 1) / num_lons
                a = _sph(radius, t0, p0)
                b = _sph(radius, t1, p0)
                c = _sph(radius, t0, p1)
                segs.append((a, b))
                segs.append((a, c))
        if pose is not None:
            segs = [(_xform(pose, a), _xform(pose, b)) for a, b in segs]
        self._verts, self._colors = _seg_array(segs, color)


class WireframeBoxGeometry(LineGeometry):
    def __init__(self, sx=1.0, sy=1.0, sz=1.0, pose=None, color=(1, 0, 0)):
        hx, hy, hz = sx / 2, sy / 2, sz / 2
        corners = [
            (x, y, z)
            for x in (-hx, hx)
            for y in (-hy, hy)
            for z in (-hz, hz)
        ]
        edges = [
            (0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7),
            (5, 1), (5, 4), (5, 7), (6, 2), (6, 4), (6, 7),
        ]
        segs = [(corners[a], corners[b]) for a, b in edges]
        if pose is not None:
            segs = [(_xform(pose, a), _xform(pose, b)) for a, b in segs]
        self._verts, self._colors = _seg_array(segs, color)


def _sph(r, theta, phi):
    return (
        r * math.sin(theta) * math.cos(phi),
        r * math.sin(theta) * math.sin(phi),
        r * math.cos(theta),
    )


def _xform(pose, p):
    from .gymapi import Vec3

    v = pose.transform_point(Vec3(*p))
    return (v.x, v.y, v.z)


def draw_lines(geom: LineGeometry, gym, viewer, env, pose=None):
    v = geom.verts()
    if pose is not None:
        v = v.copy()
        from .gymapi import Vec3

        for i in range(v.shape[0]):
            for k in range(2):
                p = pose.transform_point(
                    Vec3(v[i][k]["x"], v[i][k]["y"], v[i][k]["z"])
                )
                v[i][k] = (p.x, p.y, p.z)
    flat = np.stack(
        [
            np.stack([v[..., k]["x"], v[..., k]["y"], v[..., k]["z"]], -1)
            for k in range(2)
        ],
        axis=1,
    )
    gym.add_lines(viewer, env, geom.num_lines, flat.astype(np.float32), geom.colors())


def draw_line(p1, p2, color, gym, viewer, env):
    verts = np.array(
        [[[p1.x, p1.y, p1.z], [p2.x, p2.y, p2.z]]], np.float32
    )
    gym.add_lines(viewer, env, 1, verts, np.array([[color.x, color.y, color.z]]))

"""Plain reference of the Ant camera cell: one camera in each env over the
Ant of IsaacGymEnvs' nv_ant.xml, domain-randomized as Isaac Gym's
examples/domain_randomization.py randomizes it (an orbit pose, per-shape
colours, the light), rendered as colour, depth and segmentation.

The Ant is read from its MJCF file (ElementTree): bodies, hinges and the
sphere and capsule geoms, colours from `rgba` with the `<default>`'s
fallback. Its forward kinematics is this module's own: each body's frame is
its parent's moved by the body's `pos` and turned about its hinge's axis
by the hinge's angle, composed as quaternions from any root pose and set of
angles. A capsule's frame turns +z onto its `fromto` direction (the turn
about z x d by the angle between them), centred at its midpoint.

A frame casts each pixel's ray against the env's shapes and the ground
plane and shades the nearest hit. Its arithmetic is written from the JAX
package's render/raster.py and render/camera.py (read, never imported), in
their order of operations, so that this module run in float32 rounds as
the program does and flips the same grazing rays (the harness's float32
witness, harness/checks.py); run in float64 it is the answer:
  * the camera looks from `eye` at `target` (+x forward, +z up as far as
    possible), its pixel rays through the pixel centres at the horizontal
    fov, the vertical one from the aspect;
  * each ray is tested in each shape's frame: the sphere's test, or the
    capsule's (the cylinder about z within its half-length, then both end
    spheres); the ground plane's in the world; the nearest hit wins, the
    first shape on a tie;
  * shading: albedo x (ambient + light colour x Lambert), the normal that
    of the surface hit; the ground's albedo is `ground.albedo`; where
    nothing is hit, the sky's colour; RGBA8 by truncation, alpha 255;
  * depth is the negative view depth (along the camera's +x) where a hit
    is nearer than the far plane, -inf elsewhere; segmentation is the
    actor's id where a shape is hit, 0 on the ground and the sky.

Departures from the published deployment: Isaac Gym rasterizes with
Vulkan, and its shading (lights, shadows, the ground's texture) is not
published; this is the repository's ray-cast convention above, the one the
port's and the JAX package's renderers share. The camera's pose comes from
the frame's draws as set_camera_location sets it. The env grid is
create_env's: int(sqrt(n)) envs a row along x, rows along y, the spacing
upper - lower apart.

Every frame runs in blocks of envs of at most BLOCK ray-shape pairs, so
that it fits on the card; envs do not interact. In the control
(precision.py), the operands of every dot product and rotation are
rounded to TF32, as matrix products on the tensor cores take them.
"""
from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from .precision import round_tf32

BIG = 1e30
BLOCK = 1 << 24  # ray-shape pairs a block of envs
SPHERE, CAPSULE = 0, 1


class State(NamedTuple):
    """What a frame renders from: the scene's body poses (world) and the
    frame's draws (env-local camera eye and target, per-shape colours, the
    light)."""
    body_pos: torch.Tensor  # (N, B, 3)
    body_quat: torch.Tensor  # (N, B, 4) xyzw
    eye: torch.Tensor  # (N, 3)
    target: torch.Tensor  # (N, 3)
    colors: torch.Tensor  # (N, S, 3)
    light_color: torch.Tensor  # (3,)
    ambient: torch.Tensor  # (3,)
    light_dir: torch.Tensor  # (3,) unit, toward the scene


def compared(out):
    """The images of a frame as the comparison holds them, a unit a pixel
    of each env: RGBA8, the inverse view depth (0 where nothing is hit
    before the far plane: finite, and flat at the horizon, where float32
    cannot pin a far depth down) and the segmentation id."""
    rgba, depth, seg = out
    z = depth.to(torch.float64)
    return {"rgba": rgba.reshape(-1, 4), "seg": seg.reshape(-1),
            "inv_depth": torch.where(torch.isfinite(z), -1.0 / z, 0.0).reshape(-1)}


# ---------------------------------------------------------------- the raster's arithmetic
def _products(*xs):
    """The operands of a product (a dot product, a rotation): while TF32
    products are on (precision.tf32_matmuls: the control), rounded to TF32,
    as a matrix product on the tensor cores takes them; else as they are."""
    if torch.backends.cuda.matmul.allow_tf32:
        return tuple(round_tf32(x) for x in xs)
    return xs


def _dot(a, b):
    a, b = _products(a, b)
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(x, keepdim=False):
    return torch.sqrt(_dot(x, x)).unsqueeze(-1) if keepdim else torch.sqrt(_dot(x, x))


def _cross(a, b):
    if a.dim() != b.dim():
        a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qrot(q, v):
    """v turned by the unit quaternion q (xyzw)."""
    q, v = _products(q, v)
    t = 2.0 * _cross(q[..., :3], v)
    return v + q[..., 3:4] * t + _cross(q[..., :3], t)


def qrot_inv(q, v):
    q, v = _products(q, v)
    t = 2.0 * _cross(q[..., :3], v)
    return v - q[..., 3:4] * t + _cross(q[..., :3], t)


def qmul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def _rows(values, like):
    out = like.new_empty(like.shape[:-1] + (len(values),))
    for i, v in enumerate(values):
        out[..., i] = v
    return out


def look_at(eye, target):
    """(N, 4) camera quaternions: +x from eye to target, +z up as far as
    possible (+y up for a view along z)."""
    up_t = _rows((0.0, 0.0, 1.0), eye)
    f = target - eye
    n = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    f = torch.where(n > 1e-9, f / n, _rows((1.0, 0.0, 0.0), eye))
    along = (f * up_t).sum(-1, keepdim=True).abs() > 0.999
    up_t = torch.where(along, _rows((0.0, 1.0, 0.0), eye), up_t)
    left = _cross(up_t, f)
    left = left / torch.linalg.vector_norm(left, dim=-1, keepdim=True)
    m = torch.stack([f, left, _cross(f, left)], dim=-1)  # columns: forward, left, up

    def e(i, j):
        return m[:, i, j]

    w = torch.sqrt((1 + e(0, 0) + e(1, 1) + e(2, 2)).clamp_min(0.0)) / 2
    ws = torch.where(w > 1e-6, w, 1.0)
    q_w = torch.stack([(e(2, 1) - e(1, 2)) / (4 * ws), (e(0, 2) - e(2, 0)) / (4 * ws),
                       (e(1, 0) - e(0, 1)) / (4 * ws), w], -1)
    x = torch.sqrt((1 + e(0, 0) - e(1, 1) - e(2, 2)).clamp_min(0.0)) / 2
    y = torch.sqrt((1 - e(0, 0) + e(1, 1) - e(2, 2)).clamp_min(0.0)) / 2
    z = torch.sqrt((1 - e(0, 0) - e(1, 1) + e(2, 2)).clamp_min(0.0)) / 2
    q_x = torch.stack([torch.where(e(2, 1) - e(1, 2) >= 0, x, -x),
                       torch.where(e(0, 2) - e(2, 0) >= 0, y, -y),
                       torch.where(e(1, 0) - e(0, 1) >= 0, z, -z), w], -1)
    q = torch.where((w > 1e-6)[:, None], q_w, q_x)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def pixel_rays(width, height, hfov, quat):
    """(N, H*W, 3) world directions through the pixel centres, row 0 at the
    top, and the forward axes (N, 3)."""
    t = torch.tan(hfov * (math.pi / 180) / 2)
    fx = width / 2 / t
    u = torch.arange(width, dtype=quat.dtype, device=quat.device) + 0.5 - width / 2
    v = torch.arange(height, dtype=quat.dtype, device=quat.device) + 0.5 - height / 2
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    f = fx[:, None, None]
    d = torch.stack([torch.ones_like(uu).expand(f.shape[0], -1, -1), -uu / f, -vv / f],
                    -1).reshape(f.shape[0], -1, 3)
    d = d / _norm(d, keepdim=True)
    return qrot(quat[:, None, :], d), qrot(quat, _rows((1.0, 0.0, 0.0), quat))


def ray_sphere(o, d, c, r):
    """Entry distance along d (unit) from o into the sphere (c, r), or BIG."""
    oc = o - c
    b = _dot(oc, d)
    q = _dot(oc, oc) - r * r
    disc = b * b - q
    t = -b - torch.sqrt(disc.clamp_min(0.0))
    return torch.where((disc >= 0) & (t > 1e-4), t, BIG)


def ray_capsule(o, d, r, hl):
    """Entry distance into the capsule about z (radius r, half-length hl) of
    the ray (o, d) in the capsule's frame, or BIG."""
    a = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    b = o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1]
    c = o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1] - r * r
    disc = b * b - a * c
    root = torch.sqrt(disc.clamp_min(0.0))
    t_cyl = (-b - root) / torch.where(a < 1e-12, 1e-12, a)
    z_hit = o[..., 2] + t_cyl * d[..., 2]
    on_side = (disc >= 0) & (t_cyl > 1e-4) & (z_hit.abs() <= hl) & (a >= 1e-12)
    t_cyl = torch.where(on_side, t_cyl, BIG)
    zax = torch.zeros_like(o)
    zax[..., 2] = 1.0
    t_top = ray_sphere(o, d, zax * hl[..., None], r)
    t_bot = ray_sphere(o, d, -zax * hl[..., None], r)
    return torch.minimum(t_cyl, torch.minimum(t_top, t_bot))


# ---------------------------------------------------------------- the Ant
def _floats(text):
    return [float(x) for x in text.split()]


class Ant(NamedTuple):
    parent: list  # (B,) parent body index, -1 for the root
    offset: np.ndarray  # (B, 3) body pos in its parent's frame
    hinge: np.ndarray  # (B, 3) unit hinge axis in the body's frame (0 for the root)
    hinge_of: list  # (B,) the body's dof index, -1 for the root
    shape_body: list  # (S,) body of each shape
    shape_kind: list  # (S,) SPHERE or CAPSULE
    shape_pos: np.ndarray  # (S, 3) centre in its body's frame
    shape_quat: np.ndarray  # (S, 4) xyzw: +z onto a capsule's axis
    shape_size: np.ndarray  # (S, 2) radius, half-length (0 for a sphere)
    shape_color: np.ndarray  # (S, 3)


def read_mjcf(path) -> Ant:
    """The Ant's bodies and shapes from its MJCF: the free root body, then
    every body depth first in document order, each with at most one hinge
    at its origin; sphere and capsule (`fromto`) geoms. Body rotations,
    angles in radians and other geoms are refused."""
    root = ET.parse(path).getroot()
    comp = root.find("compiler")
    if comp is not None and comp.get("angle", "degree") != "degree":
        raise ValueError(f"{path}: angles in radians")
    geom_default = root.find("default/geom")
    default_rgba = _floats(geom_default.get("rgba", "0.7 0.7 0.7 1")
                           if geom_default is not None else "0.7 0.7 0.7 1")
    parent, offset, hinge, hinge_of = [], [], [], []
    shapes = []  # (body, kind, pos, quat, size, color)

    def geom(el, b):
        kind = el.get("type", "capsule" if el.get("fromto") else "sphere")
        color = _floats(el.get("rgba"))[:3] if el.get("rgba") else default_rgba[:3]
        r = _floats(el.get("size"))[0]
        if kind == "sphere":
            shapes.append((b, SPHERE, _floats(el.get("pos", "0 0 0")), [0.0, 0.0, 0.0, 1.0],
                           [r, 0.0], color))
        elif kind == "capsule" and el.get("fromto"):
            ft = np.array(_floats(el.get("fromto")))
            a, e = ft[:3], ft[3:]
            length = np.linalg.norm(e - a)
            z = (e - a) / length
            v = np.cross([0, 0, 1], z)
            s = np.linalg.norm(v)
            if s < 1e-9:
                quat = [0.0, 0.0, 0.0, 1.0] if z[2] > 0 else [1.0, 0.0, 0.0, 0.0]
            else:
                ax, h = v / s, np.arctan2(s, z[2]) / 2
                quat = [ax[0] * np.sin(h), ax[1] * np.sin(h), ax[2] * np.sin(h), np.cos(h)]
            shapes.append((b, CAPSULE, (a + e) / 2, quat, [r, length / 2], color))
        elif kind != "plane":
            raise ValueError(f"{path}: a {kind} geom")

    def body(el, up):
        if any(el.get(k) for k in ("quat", "euler", "axisangle", "zaxis", "xyaxes")):
            raise ValueError(f"{path}: a rotated body")
        b = len(parent)
        parent.append(up)
        offset.append(_floats(el.get("pos", "0 0 0")) if up >= 0 else [0.0, 0.0, 0.0])
        joints = el.findall("joint")
        if up < 0 or not joints:
            hinge.append([0.0, 0.0, 0.0])
            hinge_of.append(-1)
        else:
            (j,) = joints
            if j.get("type", "hinge") != "hinge" or np.any(_floats(j.get("pos", "0 0 0"))):
                raise ValueError(f"{path}: joint {j.get('name')}")
            axis = np.array(_floats(j.get("axis", "0 0 1")))
            hinge.append(axis / np.linalg.norm(axis))
            hinge_of.append(sum(h >= 0 for h in hinge_of))
        for g in el.findall("geom"):
            geom(g, b)
        for child in el.findall("body"):
            body(child, b)

    body(root.find("worldbody/body"), -1)
    sb, kind, pos, quat, size, color = zip(*shapes)
    return Ant(parent, np.array(offset), np.array(hinge), hinge_of, list(sb), list(kind),
               np.array(pos, np.float64), np.array(quat, np.float64),
               np.array(size, np.float64), np.array(color, np.float64))


def env_origins(n, lower, upper):
    """create_env's grid: int(sqrt(n)) envs a row along x, rows along y."""
    per_row = max(int(math.sqrt(n)), 1)
    step = np.asarray(upper, np.float64) - np.asarray(lower, np.float64)
    return np.array([[(i % per_row) * step[0], (i // per_row) * step[1], 0.0]
                     for i in range(n)])


def draws(gen, n, shapes, cfg, device, dtype=torch.float64):
    """A frame's draws from `gen`, as the configuration's randomizers draw
    them: the camera on its orbit, each shape's colour, the light (its
    direction from above)."""
    rz = cfg["randomize"]

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=dtype)

    theta = u((n,), 0.0, 2 * math.pi)
    r, h = u((n,), *rz["orbit_radius"]), u((n,), *rz["orbit_height"])
    target = torch.tensor(rz["orbit_center"], dtype=dtype, device=device).expand(n, 3)
    eye = target + torch.stack([r * torch.cos(theta), r * torch.sin(theta), h], -1)
    colors = u((n, shapes, 3), *rz["colors"])
    d = torch.randn(3, generator=gen, device=device, dtype=dtype)
    d = torch.cat([d[:2], -d[2:].abs() - 0.5])
    return (eye, target.clone(), colors, u((3,), *rz["light_color"]), u((3,), *rz["ambient"]),
            d / torch.linalg.vector_norm(d))


class AntCameras:
    """The cell's envs in float64 on `device`: the Ant's tables, the env
    grid, the pose of the scene, and the camera."""

    def __init__(self, cfg, root, dof_pos, device, seed=0):
        self.cfg, self.device, self.seed = cfg, device, seed
        f64 = dict(dtype=torch.float64, device=device)
        self.ant = a = read_mjcf(os.path.join(root, cfg["asset_root"], cfg["mjcf"]))
        n = cfg["num_envs"]
        self.origins = torch.tensor(env_origins(n, cfg["env_lower"], cfg["env_upper"]), **f64)
        self.dof_pos = torch.as_tensor(dof_pos, **f64)  # (N, dofs)
        self.body = torch.tensor(a.shape_body, device=device)
        self.kind = torch.tensor(a.shape_kind, device=device)
        self.shape_pos, self.shape_quat, self.shape_size = (
            torch.tensor(x, **f64) for x in (a.shape_pos, a.shape_quat, a.shape_size))
        self.seg_id = cfg["segmentation_id"]
        self.cam = cfg["camera"]

    def pose(self, root_pos, root_quat, dof_pos):
        """(body_pos (N, B, 3), body_quat (N, B, 4)) world: each body its
        parent's frame moved by its offset and turned about its hinge."""
        a = self.ant
        pos, quat = [], []
        for b, up in enumerate(a.parent):
            if up < 0:
                pos.append(root_pos)
                quat.append(root_quat)
                continue
            angle = dof_pos[:, a.hinge_of[b]][:, None] / 2
            axis = torch.as_tensor(a.hinge[b], dtype=root_pos.dtype, device=root_pos.device)
            turn = torch.cat([axis * torch.sin(angle), torch.cos(angle)], -1)
            off = torch.as_tensor(a.offset[b], dtype=root_pos.dtype, device=root_pos.device)
            pos.append(pos[up] + qrot(quat[up], off.expand_as(pos[up])))
            quat.append(qmul(quat[up], turn))
        return torch.stack(pos, 1), torch.stack(quat, 1)

    def start(self):
        n = self.origins.shape[0]
        root = self.origins + torch.tensor(self.cfg["root_pos"], dtype=torch.float64,
                                           device=self.device)
        quat = torch.zeros((n, 4), dtype=torch.float64, device=self.device)
        quat[:, 3] = 1.0
        gen = torch.Generator(device=self.device).manual_seed(self.seed % 2**63)
        return State(*self.pose(root, quat, self.dof_pos),
                     *draws(gen, n, len(self.ant.shape_kind), self.cfg, self.device))

    def shapes(self, body_pos, body_quat):
        """Every shape's world (pos (N, S, 3), quat (N, S, 4)) from its body's."""
        dt = body_pos.dtype
        bp, bq = body_pos[:, self.body], body_quat[:, self.body]
        return (bp + qrot(bq, self.shape_pos.to(dt).expand(bp.shape)),
                qmul(bq, self.shape_quat.to(dt).expand(bq.shape)))

    def fields(self, state, out):
        """Start (out None): every shape's pose and size, env-local; a
        frame: its images (`compared`)."""
        if out is not None:
            return compared(out)
        sp, sq = self.shapes(state.body_pos, state.body_quat)
        return shape_fields(sp - self.origins.to(sp.dtype)[:, None], sq,
                            self.shape_size.expand(sp.shape[:2] + (2,)))

    def step(self, state, dtype=torch.float64):
        """The frame of `state`'s draws: (state, (rgba, depth, seg))."""
        s = State(*(t.to(device=self.device, dtype=dtype) for t in state))
        images = self.render(s.body_pos, s.body_quat, s.eye + self.origins.to(dtype), s.eye,
                             s.target, s.colors, torch.full_like(self.kind, self.seg_id),
                             s.light_color, s.ambient, s.light_dir, self.cam["width"],
                             self.cam["height"], self.cam["far_plane"],
                             self.cam["horizontal_fov"])
        return state, images

    def render(self, body_pos, body_quat, cam_pos, eye, target, colors, seg, light_color,
               ambient, light_dir, width, height, far, hfov):
        """(rgba (N, H, W, 4) uint8, depth (N, H, W), seg (N, H, W) int32) of
        each env's camera at cam_pos (world) looking from eye to target
        (the look's direction is target - eye)."""
        dt, dev = body_pos.dtype, body_pos.device
        n, P, S = body_pos.shape[0], width * height, len(self.ant.shape_kind)
        sp, sq = self.shapes(body_pos, body_quat)
        size = self.shape_size.to(dt)
        quat = look_at(eye, target)
        g = self.cfg["ground"]
        ground = torch.tensor(list(g["normal"]) + [g["distance"]], dtype=dt, device=dev)
        sky = torch.tensor(self.cfg["sky"], dtype=dt, device=dev)
        rgba = torch.empty((n, P, 4), dtype=torch.uint8, device=dev)
        depth = torch.empty((n, P), dtype=dt, device=dev)
        seg_img = torch.empty((n, P), dtype=torch.int32, device=dev)
        sph = [i for i, k in enumerate(self.ant.shape_kind) if k == SPHERE]
        cap = [i for i, k in enumerate(self.ant.shape_kind) if k == CAPSULE]
        step = max(1, BLOCK // (P * S))
        for e0 in range(0, n, step):
            es = slice(e0, min(n, e0 + step))
            dirs, fwd = pixel_rays(width, height, torch.full((es.stop - e0,), hfov, dtype=dt,
                                                           device=dev), quat[es])
            o, p_, q_ = cam_pos[es], sp[es], sq[es]
            o_l = qrot_inv(q_[:, None], (o[:, None, :] - p_)[:, None])  # (n, 1, S, 3)
            d_l = qrot_inv(q_[:, None], dirs[:, :, None, :].expand(-1, -1, S, 3))
            t = torch.full(d_l.shape[:3], BIG, dtype=dt, device=dev)
            r, hl = size[:, 0], size[:, 1]
            t[..., sph] = ray_sphere(o_l[:, :, sph], d_l[:, :, sph],
                                     torch.zeros_like(o_l[:, :, sph]), r[sph])
            t[..., cap] = ray_capsule(o_l[:, :, cap], d_l[:, :, cap], r[cap], hl[cap])
            t_best, best = t.min(-1)
            # the ground plane
            denom = _dot(dirs, ground[:3])
            t_gnd = (ground[3] - _dot(o, ground[:3]))[:, None] / torch.where(
                denom.abs() < 1e-9, 1e-9, denom)
            t_gnd = torch.where((_norm(ground[:3]) > 0.5) & (t_gnd > 1e-4), t_gnd, BIG)
            on_shape = t_best < torch.clamp_max(t_gnd, BIG * 0.5)
            on_ground = (~on_shape) & (t_gnd < BIG * 0.5)
            t_hit = torch.where(on_shape, t_best, t_gnd)
            # shading, at the nearest hit
            p_hit = o[:, None, :] + t_hit[..., None] * dirs
            sp_b, sq_b = take(p_, best), take(q_, best)
            size_b = size[best]
            p_l = qrot_inv(sq_b, p_hit - sp_b)
            zclip = torch.minimum(torch.maximum(p_l[..., 2], -size_b[..., 1]), size_b[..., 1])
            n_cap = p_l - torch.stack([torch.zeros_like(zclip), torch.zeros_like(zclip), zclip],
                                      -1)
            n_l = torch.where((self.kind[best] == SPHERE)[..., None], p_l, n_cap)
            n_w = torch.where(on_ground[..., None], ground[:3].expand(p_l.shape), qrot(sq_b, n_l))
            n_w = n_w / _norm(n_w, keepdim=True).clamp_min(1e-9)
            albedo = torch.where(on_ground[..., None], g["albedo"], take(colors[es], best))
            lambert = (-_dot(n_w, light_dir)).clamp(0.0, 1.0)
            shade = albedo * (ambient + light_color * lambert[..., None])
            hit = on_shape | on_ground
            rgb = torch.where(hit[..., None], shade, sky.expand(shade.shape))
            rgba[es] = (torch.cat([rgb.clamp(0, 1), torch.ones_like(rgb[..., :1])], -1)
                        * 255).to(torch.uint8)
            z = t_hit * _dot(dirs, fwd[:, None, :])
            depth[es] = torch.where(hit & (t_hit < far), -z, -math.inf)
            seg_img[es] = torch.where(on_shape, seg[best], 0).to(torch.int32)
        return (rgba.reshape(n, height, width, 4), depth.reshape(n, height, width),
                seg_img.reshape(n, height, width))


def take(x, idx):
    """x (n, S, k) gathered at idx (n, p) along S: (n, p, k)."""
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + x.shape[2:]))


def shape_fields(pos, quat, size):
    """The start's fields: each shape's env-local centre, the world
    direction of its +z (a capsule's axis) and its radius and half-length."""
    return {"shape_pos": pos, "shape_axis": qrot(quat, _rows((0.0, 0.0, 1.0), pos)),
            "shape_size": size}

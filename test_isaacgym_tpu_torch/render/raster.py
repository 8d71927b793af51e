"""Batched analytic ray-cast renderer.

Port of test_isaacgym_tpu/render/raster.py. Camera sensors render by
ray-casting the scene's collision/visual primitives (sphere/box/capsule,
convex hulls of meshes, visual triangle meshes, soft-body surfaces, the
ground plane) with plain PyTorch ops over (env, pixel, shape). The JAX
package's `jax.vmap` over envs is a leading env axis here. It replaces the
reference's Vulkan render path (`render_all_camera_sensors` +
`get_camera_image(IMAGE_COLOR|IMAGE_DEPTH)`, the reference's
test/test02_isaacgym_camera.py:316-343, examples/graphics.py:225-238).

Outputs per camera:
  color (N, H, W, 4) uint8   — Lambert-shaded albedo or sampled texture, RGBA
  depth (N, H, W) float32    — NEGATIVE view-space depth, -inf where no hit
  seg   (N, H, W) int32      — per-actor segmentation ids (0 = background)
  flow  (N, H, W, 2) float32 — optical flow in pixels, when asked for

Features: per-shape textures sampled from a stacked atlas with analytic UVs;
a per-env horizontal fov; supersampling (render at ss × res, box-downsample);
a bounding-sphere frustum cull that keeps the `cull_max` nearest shapes of an
env, in the order of a stable sort of their distance (the JAX package's
`lax.top_k` keeps ties in index order; `torch.topk` promises no tie order).

Memory and determinism. The primitive pass holds several (rays, shapes, 3)
tensors, so it runs in blocks of envs and rays of at most `BLOCK_ELEMS`
ray-shape pairs; the triangle and line passes run per env over all of its
rays first, the triangles in `TRI_CHUNK`-ray chunks as the JAX package's
`lax.map` does. Every per-ray value is computed by elementwise ops and
reductions over the shape axis (the 3-term dot products are written out),
so the images are the same bits whatever the blocking. The hit attributes
of a triangle are a gather by the winning index, the function of the JAX
package's one-hot product `oh @ pack` with its one nonzero term.

On a CUDA device, a frame that asks for the primitive pass alone (no
texture, hull rows, triangles, soft triangles, lines or optical flow, and
ss 1) is one launch of csrc/raycast.cu, which follows these ops' arithmetic
in their order and gives their bits; its focal lengths and forward axes stay
eager (`_kernel_frame`, `_raycast_cuda`). Every other frame, and every frame
on the CPU, runs the ops below.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..assets.types import GEOM_MESH as GEOM_MESH_KIND
from ..core.scene import SHAPE_BOX, SHAPE_CAPSULE, SHAPE_MESH, SHAPE_SPHERE, Scene
from ..math.quat import const_rows, cross, quat_mul, quat_rotate, quat_rotate_inverse
from ..ops import _kernels
from ..utils.trace import span, stage

BIG = 1e30
TEX_RES = 128  # atlas resolution textures are resampled to
MAX_RENDER_TRIS = 512  # per-shape visual-mesh triangle budget (decimated)
TRI_CHUNK = 65536  # rays per Moller-Trumbore product (raster.py:304's chunk)
BLOCK_ELEMS = 1 << 25  # ray x shape-column pairs per block of the primitive pass


def _np_qrot(q, v):
    """numpy xyzw quaternion rotate, q (4,) or (...,4), v (..., 3)."""
    q = np.asarray(q, np.float32)
    u, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(np.broadcast_to(u, v.shape), v)
    return v + w * t + np.cross(np.broadcast_to(u, v.shape), t)


def _np_qrot_inv(q, v):
    q = np.asarray(q, np.float32)
    return _np_qrot(np.concatenate([-q[..., :3], q[..., 3:4]], -1), v)


class RenderTables(NamedTuple):
    """Static per-env-template shape tables: host numpy, or tensors on a
    device after `to` (`tables_from_scene(scene, device)`)."""

    body: np.ndarray  # (S,) env body index
    kind: np.ndarray  # (S,)
    quat: np.ndarray  # (S, 4) shape rot in link frame
    color: np.ndarray  # (S, 3) albedo
    seg: np.ndarray  # (S,) actor segmentation id
    # mesh silhouettes: convex-hull plane tables for SHAPE_MESH rows, so a
    # mesh renders as its hull instead of a bounding box. mesh_rows (Sm,)
    # indexes the S axis; mesh_planes (Sm, F, 4) LOCAL [n, d] rows padded
    # with (0,0,0,-1); mesh_base (Sm, 3) the build-time AABB half extents
    # (runtime shape_size / mesh_base = render scale).
    mesh_rows: np.ndarray
    mesh_planes: np.ndarray
    mesh_base: np.ndarray
    # visual triangle meshes: flat table over all mesh shapes' decimated
    # visual triangles, in each shape's LOCAL frame. tri_shape (T,) shape
    # row of each triangle; tri_v (T, 3, 3) corner positions; tri_n (T, 3, 3)
    # corner normals (smooth per-vertex for COMPUTE_PER_VERTEX, flat
    # otherwise). Empty when no mesh in the scene carries a visual mesh.
    tri_shape: np.ndarray
    tri_v: np.ndarray
    tri_n: np.ndarray

    def to(self, device) -> "RenderTables":
        """The tables as tensors on `device`, each of its own dtype: copied
        there once, so that a frame that reads them makes no host copy."""
        return RenderTables(*(torch.as_tensor(x, device=device) for x in self))


def tables_from_scene(scene: Scene, device=None) -> RenderTables:
    """The scene's render tables, numpy; with `device`, copied there once
    (`RenderTables.to`)."""
    with stage("setup.render"):
        tables = _tables_from_scene(scene)
        return tables if device is None else tables.to(device)


def _tables_from_scene(scene: Scene) -> RenderTables:
    sh = scene.shapes
    colors = np.full((sh.count, 3), 0.7, np.float32)
    seg = np.zeros(sh.count, np.int32)
    # visual triangle tables: per mesh-shape row, the link's visual meshes
    # decimated to MAX_RENDER_TRIS and expressed in the shape's local frame
    # (the hull vertices' frame: g.quat orientation about the mesh-AABB
    # center, as core/scene.py builds shapes)
    from .meshtools import decimate, triangle_table, vertex_normals

    tri_shape_l, tri_v_l, tri_n_l = [], [], []
    tri_cache: dict = {}

    def _vis_tris(link, g, smooth):
        """Collect link visual meshes in the COLLISION shape's frame."""
        out_v, out_n = [], []
        cands = [
            vg
            for vg in link.visuals
            if vg.kind == GEOM_MESH_KIND
            and vg.vertices is not None
            and vg.faces is not None
            and len(vg.faces)
            # collision geoms aliased into visuals have HULLED vertices
            # with the original faces dangling: reject those
            and int(np.max(vg.faces)) < len(vg.vertices)
        ]
        if not cands and getattr(g, "visual_vertices", None) is not None:
            v = np.asarray(g.visual_vertices, np.float32)
            f = np.asarray(g.visual_faces, np.int64)
            v2, f2, n2 = decimate(v, f, MAX_RENDER_TRIS)
            return triangle_table(v2, f2, n2, smooth)
        budget = max(MAX_RENDER_TRIS // max(len(cands), 1), 64)
        qg = np.asarray(g.quat, np.float32)
        pg = np.asarray(g.center(), np.float32)
        for vg in cands:
            v = np.asarray(vg.vertices, np.float32)
            if vg.mesh_scale is not None:
                v = v * np.asarray(vg.mesh_scale, np.float32)
            f = np.asarray(vg.faces, np.int64)
            nrm = vertex_normals(v, f)
            v2, f2, n2 = decimate(v, f, budget, nrm)
            # visual geom frame -> link frame -> collision shape frame
            v_link = np.asarray(vg.pos, np.float32) + _np_qrot(
                np.asarray(vg.quat, np.float32), v2
            )
            v_sh = _np_qrot_inv(qg, v_link - pg)
            n_sh = _np_qrot_inv(qg, _np_qrot(np.asarray(vg.quat, np.float32), n2))
            tv, tn = triangle_table(v_sh, f2, n_sh, smooth)
            out_v.append(tv)
            out_n.append(tn)
        if not out_v:
            return None
        return np.concatenate(out_v, 0), np.concatenate(out_n, 0)

    # default albedo from visual colors where the asset provides one
    i = 0
    for p in scene.actors:
        for l in p.asset.links:
            link_done = False
            for g in l.geoms:
                if g.color is not None:
                    colors[i] = g.color
                seg[i] = p.seg_id
                if g.kind == GEOM_MESH_KIND and not link_done and sh.kind[i] == SHAPE_MESH:
                    smooth = getattr(p.asset, "mesh_normal_mode", 0) == 0
                    key = (id(l), smooth)
                    if key not in tri_cache:
                        tri_cache[key] = _vis_tris(l, g, smooth)
                    tt = tri_cache[key]
                    if tt is not None:
                        tri_shape_l.append(np.full(len(tt[0]), i, np.int32))
                        tri_v_l.append(tt[0])
                        tri_n_l.append(tt[1])
                        link_done = True
                i += 1

    # hull plane tables for mesh shapes
    from ..physics.contacts import _hull_planes

    mesh_rows, plane_sets = [], []
    if sh.hull_id is not None:
        for s in range(sh.count):
            hid = sh.hull_id[s]
            if sh.kind[s] == SHAPE_MESH and hid >= 0 and len(scene.hulls[hid]) >= 4:
                mesh_rows.append(s)
                plane_sets.append(_hull_planes(np.asarray(scene.hulls[hid])))
    if mesh_rows:
        F = max(len(pl) for pl in plane_sets)
        planes = np.zeros((len(mesh_rows), F, 4), np.float32)
        planes[..., 3] = -1.0  # pad rows: 0.x - 1 <= 0, never constrains
        for k, pl in enumerate(plane_sets):
            planes[k, : len(pl)] = pl
        base = np.maximum(np.asarray(sh.size, np.float32)[mesh_rows], 1e-6)
    else:
        planes = np.zeros((0, 1, 4), np.float32)
        base = np.zeros((0, 3), np.float32)
    if tri_v_l:
        tri_shape = np.concatenate(tri_shape_l)
        tri_v = np.concatenate(tri_v_l, 0).astype(np.float32)
        tri_n = np.concatenate(tri_n_l, 0).astype(np.float32)
    else:
        tri_shape = np.zeros(0, np.int32)
        tri_v = np.zeros((0, 3, 3), np.float32)
        tri_n = np.zeros((0, 3, 3), np.float32)
    return RenderTables(
        body=np.asarray(sh.body_slot, np.int32),
        kind=np.asarray(sh.kind, np.int32),
        quat=np.asarray(sh.quat, np.float32),
        color=colors,
        seg=seg,
        mesh_rows=np.asarray(mesh_rows, np.int32),
        mesh_planes=planes,
        mesh_base=base,
        tri_shape=tri_shape,
        tri_v=tri_v,
        tri_n=tri_n,
    )


def resample_texture(img: np.ndarray, res: int = TEX_RES) -> np.ndarray:
    """Nearest-resample an (H, W, 3|4) uint8/float image to (res, res, 3)
    float32 in [0, 1] for the stacked atlas."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    img = img[..., :3]
    iy = np.clip((np.arange(res) + 0.5) * img.shape[0] / res, 0, img.shape[0] - 1)
    ix = np.clip((np.arange(res) + 0.5) * img.shape[1] / res, 0, img.shape[1] - 1)
    return img[iy.astype(int)][:, ix.astype(int)].astype(np.float32)


def _dot(a, b):
    """Dot product over a last axis of 3, written out: elementwise ops only,
    so a ray's value does not depend on how many rays share the call."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(x, keepdim=False):
    return torch.sqrt(_dot(x, x)).unsqueeze(-1) if keepdim else torch.sqrt(_dot(x, x))


def _signed_eps(x, eps):
    """x, with |x| < eps replaced by +-eps (its sign, + at 0)."""
    return torch.where(x.abs() < eps, torch.where(x >= 0, eps, -eps), x)


def _ray_sphere(o, d, c, r):
    """o,d (..., 3); c (..., 3); r (...,). Returns t (...,) or BIG."""
    oc = o - c
    b = _dot(oc, d)
    q = _dot(oc, oc) - r * r
    disc = b * b - q
    t = -b - torch.sqrt(disc.clamp_min(0.0))
    return torch.where((disc >= 0) & (t > 1e-4), t, BIG)


def _ray_box(o, d, half):
    """Ray vs axis-aligned box in LOCAL frame. o,d (..., 3), half (..., 3)."""
    inv = 1.0 / _signed_eps(d, 1e-9)
    t0 = (-half - o) * inv
    t1 = (half - o) * inv
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    hit = (tmax >= tmin.clamp_min(1e-4)) & (tmax > 0)
    t = torch.where(tmin > 1e-4, tmin, tmax)
    return torch.where(hit, t, BIG)


def _ray_convex(o, d, planes):
    """Ray vs convex solid from outward planes (n.x + d_pl <= 0 inside, the
    convention of physics/contacts.py::_hull_planes). o, d (..., 3); planes
    (..., F, 4) broadcastable. Returns (t, n_hit): the entry distance or BIG,
    and the unit normal of the entering face."""
    n = planes[..., :3]
    dpl = planes[..., 3]
    dn = _dot(d[..., None, :], n)  # (..., F)
    f0 = _dot(o[..., None, :], n) + dpl
    t_pl = -f0 / _signed_eps(dn, 1e-9)
    lower = torch.where(dn < -1e-9, t_pl, -BIG)
    upper = torch.where(dn > 1e-9, t_pl, BIG)
    # parallel + outside: miss
    miss_par = ((dn.abs() <= 1e-9) & (f0 > 0)).any(-1)
    tmin, kmin = lower.max(-1)  # first max, as jnp.argmax
    tmax = upper.amin(-1)
    hit = (~miss_par) & (tmax >= tmin.clamp_min(1e-4)) & (tmax > 0)
    t = torch.where(tmin > 1e-4, tmin, tmax)
    n_all = n.expand(kmin.shape + n.shape[-2:])
    n_hit = torch.gather(n_all, -2, kmin[..., None, None].expand(kmin.shape + (1, 3)))[..., 0, :]
    return torch.where(hit, t, BIG), n_hit


def _ray_capsule(o, d, r, hl):
    """Ray vs z-aligned capsule in LOCAL frame."""
    # infinite cylinder on xy
    a = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    b = o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1]
    c = o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1] - r * r
    disc = b * b - a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    a_safe = torch.where(a < 1e-12, 1e-12, a)
    t_cyl = (-b - sq) / a_safe
    z_hit = o[..., 2] + t_cyl * d[..., 2]
    cyl_ok = (disc >= 0) & (t_cyl > 1e-4) & (z_hit.abs() <= hl) & (a >= 1e-12)
    t_cyl = torch.where(cyl_ok, t_cyl, BIG)
    # end spheres
    zax = torch.zeros_like(o)
    zax[..., 2] = 1.0
    t_top = _ray_sphere(o, d, zax * hl[..., None], r)
    t_bot = _ray_sphere(o, d, -zax * hl[..., None], r)
    return torch.minimum(t_cyl, torch.minimum(t_top, t_bot))


def _ray_triangles(origin, dirs, tv, tn, tcol, tseg, tsid=None, chunk=TRI_CHUNK):
    """Batched Moller-Trumbore against a world-frame triangle soup, one env.

    origin (3,); dirs (P, 3); tv (T, 3, 3) corner positions; tn (T, 3, 3)
    corner normals; tcol (T, 3); tseg (T,); tsid (T,) shape row or -1.
    Returns per-ray (t (P,), n_world (P,3) barycentric-interpolated,
    color (P,3), seg (P,), sid (P,)).

    With one origin per env, every ray-dependent term is a (P,3)@(3,T)
    product: a = -d.(e1 x e2), u = f d.(e2 x s), v = f d.(s x e1), one K=3
    matmul (f32 and exact only with TF32 off, PyTorch's default). More
    than `chunk` rays run in chunks of `chunk`, the last padded, so every
    product has one shape. The winner's attributes are a gather by its
    index."""
    P = dirs.shape[0]
    T = tv.shape[0]
    v0, v1, v2 = tv[:, 0], tv[:, 1], tv[:, 2]
    e1 = v1 - v0  # (T, 3)
    e2 = v2 - v0
    s = origin[None, :] - v0  # (T, 3)
    n2 = cross(e1, e2)  # unnormalized face normal
    c_u = cross(e2, s)
    c_v = cross(s, e1)
    t_num = (e2 * c_v).sum(-1)  # (T,) = e2 . (s x e1)
    # packed per-tri hit attributes [n0 | n1 | n2 | color | seg | sid+1]
    sid_col = (torch.zeros((T, 1), dtype=tv.dtype, device=tv.device) if tsid is None
               else tsid.to(tv.dtype)[:, None] + 1.0)
    pack = torch.cat([tn.reshape(T, 9), tcol, tseg.to(tv.dtype)[:, None], sid_col], -1)
    rhs = torch.cat([-n2, c_u, c_v], 0).T  # (3, 3T)

    def run(d):
        auv = d @ rhs  # (p, 3T)
        a = auv[:, :T]
        f = 1.0 / torch.where(a.abs() < 1e-12, 1e-12, a)
        u = f * auv[:, T: 2 * T]
        v = f * auv[:, 2 * T:]
        t = f * t_num[None, :]
        ok = (a.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
        t = torch.where(ok, t, BIG)
        tb, ib = t.min(-1)  # first-min index: exactly one
        hit = ok.gather(-1, ib[:, None])[:, 0]
        ub = torch.where(hit, u.gather(-1, ib[:, None])[:, 0], 0.0)
        vb = torch.where(hit, v.gather(-1, ib[:, None])[:, 0], 0.0)
        att = torch.where(hit[:, None], pack[ib], 0.0)  # (p, 14)
        n = ((1.0 - ub - vb)[:, None] * att[:, 0:3] + ub[:, None] * att[:, 3:6]
             + vb[:, None] * att[:, 6:9])
        return tb, n, att[:, 9:12], att[:, 12], att[:, 13] - 1.0  # sid: 0 (miss) -> -1

    if P <= chunk:
        tb, n, col, sg, sid = run(dirs)
    else:
        pad = (-P) % chunk
        dp = torch.cat([dirs, dirs.new_zeros((pad, 3))], 0)
        outs = [run(dp[i: i + chunk]) for i in range(0, P + pad, chunk)]
        tb, n, col, sg, sid = (torch.cat(parts, 0)[:P] for parts in zip(*outs))
    n = n / _norm(n, keepdim=True).clamp_min(1e-9)
    return tb, n, col, sg.to(torch.int32), sid.to(torch.int32)


def _ray_lines(origin, dirs, seg_a, seg_b, px_ang):
    """Ray-vs-line-segment overlay test (gymutil.draw_lines / viewer
    add_lines, the reference's test/test01_isaacgym_asset.py:218-219), one
    env.

    seg_a/seg_b (L, 3) world endpoints. A ray 'hits' a segment when the
    closest distance between the ray and the segment is under the pixel
    footprint (px_ang * t, clamped to >= 2 mm so near lines stay visible).
    Returns (t (P,), hit (P,), idx (P,) the nearest segment's index)."""
    d = dirs[:, None, :]  # (P, 1, 3)
    u = seg_b - seg_a  # (L, 3)
    w0 = origin[None, :] - seg_a  # (L, 3)
    b = _dot(d, u[None])  # (P, L)
    c = (u * u).sum(-1)[None, :].clamp_min(1e-12)  # (1, L)
    dd = _dot(d, w0[None])  # (P, L) = d . w0
    e = (u * w0).sum(-1)[None, :]  # (1, L)
    den = (c - b * b).clamp_min(1e-12)  # |d|^2 = 1
    tc = ((e - b * dd) / den).clamp(0.0, 1.0)  # segment param
    # ray param of the clamped segment point
    rel = seg_a[None, :, :] + tc[..., None] * u[None, :, :] - origin[None, None, :]
    sc = _dot(rel, d)  # (P, L)
    dist = _norm(rel - sc[..., None] * d)
    eps = (px_ang * sc.abs()).clamp_min(2e-3)
    ok = (sc > 1e-4) & (dist <= eps)
    t = torch.where(ok, sc, BIG)
    tb, ib = t.min(-1)
    return tb, tb < BIG * 0.5, ib


def _shape_uv(p_l, kind, size):
    """Analytic texture coordinates of a local-frame surface point.

    box/mesh: planar projection on the dominant face; sphere: equirect;
    capsule: cylindrical. p_l (..., 3), kind (...,), size (..., 3) ->
    uv (..., 2)."""
    r = size[..., 0].clamp_min(1e-6)
    hl = size[..., 1]
    # sphere: equirectangular
    u_s = torch.atan2(p_l[..., 1], p_l[..., 0]) / (2 * math.pi) + 0.5
    v_s = 0.5 - torch.asin((p_l[..., 2] / r).clamp(-1, 1)) / math.pi
    # box: dominant axis face, project the other two
    half = size.clamp_min(1e-6)
    ax = (p_l.abs() / half).argmax(-1)
    perm = torch.tensor([[1, 2], [0, 2], [0, 1]], device=p_l.device)  # uv axes per face
    sel = perm[ax]  # (..., 2)
    uv_b = p_l.gather(-1, sel) / (2 * half.gather(-1, sel)) + 0.5
    # capsule: cylindrical
    v_c = (p_l[..., 2] + hl + r) / (2 * (hl + r)).clamp_min(1e-6)
    is_sphere = (kind == SHAPE_SPHERE)[..., None]
    is_cap = (kind == SHAPE_CAPSULE)[..., None]
    uv = torch.where(is_sphere, torch.stack([u_s, v_s], -1),
                     torch.where(is_cap, torch.stack([u_s, v_c], -1), uv_b))
    return uv.clamp(0.0, 1.0)


def _sample_atlas(tex, tid, uv):
    """Nearest sample of a stacked (T, R, R, 3) atlas. tid (...,) int (-1 =
    untextured; callers mask). uv (..., 2) in [0,1]."""
    R = tex.shape[1]
    ix = (uv[..., 0] * R).to(torch.int32).clamp(0, R - 1).long()
    iy = (uv[..., 1] * R).to(torch.int32).clamp(0, R - 1).long()
    t = tid.clamp(0, tex.shape[0] - 1).long()
    return tex[t, iy, ix]


def _take(x, idx):
    """x (n, S, ...) gathered at idx (n, p) along S -> (n, p, ...)."""
    flat = idx.reshape(idx.shape[0], -1)
    view = flat.reshape(flat.shape + (1,) * (x.dim() - 2)).expand(flat.shape + x.shape[2:])
    return torch.gather(x, 1, view)


def _primitive_block(o, dirs, sp, sq, ssize, kind, color, seg, ground, light_dir, light_color,
                     ambient, bg, tex, tex_id, hull, tri_excl, tri, line):
    """The primitive, hull and ground pass and the shading of a block of
    rays: o (n, 3), dirs (n, p, 3), per-env shape tables (n, S, ...).
    `hull` is (rows (Sm,) long, inv (S,) long, is_hull (S,) bool, planes
    (n, Sm, F, 4)) or None; `tri` and `line` are the per-ray results of the
    triangle and line passes on this block, or None."""
    n, p = dirs.shape[:2]
    S = sp.shape[1]
    q = sq[:, None]  # (n, 1, S, 4)
    # the camera in each shape's frame does not depend on the ray: (n, 1, S, 3)
    o_l = quat_rotate_inverse(q, (o[:, None, :] - sp)[:, None])
    d_l = quat_rotate_inverse(q, dirs[:, :, None, :].expand(n, p, S, 3))
    r = ssize[:, None, :, 0]
    hl = ssize[:, None, :, 1]
    half = ssize[:, None]

    t_sph = _ray_sphere(o_l, d_l, torch.zeros_like(o_l), r)
    t_box = _ray_box(o_l, d_l, half)
    t_cap = _ray_capsule(o_l, d_l, r, hl)
    k = kind[:, None, :]
    t = torch.where(k == SHAPE_SPHERE, t_sph, BIG)
    box_like = (k == SHAPE_BOX) | (k == SHAPE_MESH)
    if hull is not None:
        box_like = box_like & ~hull[2]
    t = torch.where(box_like, t_box, t)
    t = torch.where(k == SHAPE_CAPSULE, t_cap, t)  # (n, p, S)

    n_hull = None
    if hull is not None:
        rows, inv_mesh, is_hull, planes = hull
        t_m, n_hull = _ray_convex(o_l[:, :, rows], d_l[:, :, rows], planes[:, None])
        t = t.index_copy(2, rows, t_m)  # (n, p, Sm, 3) local-frame entering normals

    if tri_excl is not None:
        # shapes with visual triangle meshes render in the tri pass; their
        # primitive/hull candidates go (after the hull pass writes its rows)
        # so the hull can't fill a concave mesh's cavities
        t = torch.where(tri_excl, BIG, t)

    t_best, best = t.min(-1)  # (n, p) first min

    tri_hit = None
    if tri is not None:
        t_tri, n_tri, c_tri, sg_tri, sid_tri = tri
        tri_hit = t_tri < t_best  # a triangle beats every primitive/hull
        t_best = torch.minimum(t_best, t_tri)
        # flow/shading bookkeeping follows the winning triangle's shape row
        # (soft-surface tris carry sid -1: keep the primitive best)
        best = torch.where(tri_hit & (sid_tri >= 0), sid_tri.long(), best)

    # ground plane
    gn = ground[:3]
    has_ground = _norm(gn) > 0.5
    denom = _dot(dirs, gn)
    t_gnd = (ground[3] - _dot(o, gn))[:, None] / torch.where(denom.abs() < 1e-9, 1e-9, denom)
    t_gnd = torch.where(has_ground & (t_gnd > 1e-4), t_gnd, BIG)

    hit_shape = t_best < torch.clamp_max(t_gnd, BIG * 0.5)
    hit_gnd = (~hit_shape) & (t_gnd < BIG * 0.5)
    t_final = torch.where(hit_shape, t_best, t_gnd)

    # shading
    p_hit = o[:, None, :] + t_final[..., None] * dirs
    c_shape = _take(color, best)
    sp_b, sq_b, ss_b = _take(sp, best), _take(sq, best), _take(ssize, best)
    p_l = quat_rotate_inverse(sq_b, p_hit - sp_b)
    kb = _take(kind, best)
    ax = (p_l.abs() / ss_b.clamp_min(1e-6)).argmax(-1)
    n_box = (torch.nn.functional.one_hot(ax, 3).to(p_l.dtype)
             * torch.sign(p_l.gather(-1, ax[..., None])))
    zclip = torch.minimum(torch.maximum(p_l[..., 2], -ss_b[..., 1]), ss_b[..., 1])
    n_cap = p_l - torch.stack([torch.zeros_like(zclip), torch.zeros_like(zclip), zclip], -1)
    n_l = torch.where((kb == SHAPE_SPHERE)[..., None], p_l,
                      torch.where((kb == SHAPE_CAPSULE)[..., None], n_cap, n_box))
    if n_hull is not None:
        is_hull_best = is_hull[best]
        nm = torch.gather(n_hull, 2, inv_mesh[best][..., None, None].expand(n, p, 1, 3))[:, :, 0]
        n_l = torch.where(is_hull_best[..., None], nm, n_l)
    n_w = quat_rotate(sq_b, n_l)
    if tri_hit is not None:
        # triangle hits carry their own world-space interpolated normals and
        # per-tri colors
        n_w = torch.where(tri_hit[..., None], n_tri, n_w)
        c_shape = torch.where(tri_hit[..., None], c_tri, c_shape)
    n_w = torch.where(hit_gnd[..., None], gn.expand(n_w.shape), n_w)
    n_w = n_w / _norm(n_w, keepdim=True).clamp_min(1e-9)
    if tri_hit is not None:
        # double-sided shading for triangle soups: flip normals facing away
        away = _dot(n_w, dirs)[..., None] > 0
        n_w = torch.where(tri_hit[..., None] & away, -n_w, n_w)

    if tex_id is not None:
        tid = _take(tex_id, best)
        if tri_hit is not None:
            tid = torch.where(tri_hit, -1, tid)  # tri colors win
        t_col = _sample_atlas(tex, tid, _shape_uv(p_l, kb, ss_b))
        c_shape = torch.where((tid >= 0)[..., None], t_col, c_shape)

    albedo = torch.where(hit_gnd[..., None], 0.55, c_shape)
    lambert = (-_dot(n_w, light_dir)).clamp(0.0, 1.0)
    shade = albedo * (ambient + light_color * lambert[..., None])
    rgb = torch.where((hit_shape | hit_gnd)[..., None], shade, bg.expand(shade.shape))
    if line is not None:
        # debug-draw overlay: unshaded line color wherever a segment passes
        # the depth test
        t_line, l_hit, l_col = line
        vis = l_hit & (t_line < t_final)
        rgb = torch.where(vis[..., None], l_col, rgb)
    rgba = torch.cat([rgb.clamp(0, 1), torch.ones_like(rgb[..., :1])], -1)

    seg_img = torch.where(hit_shape, _take(seg, best), 0)
    if tri_hit is not None:
        seg_img = torch.where(tri_hit & hit_shape, sg_tri, seg_img)
    return rgba, t_final, (hit_shape | hit_gnd), seg_img, best, hit_shape


def render_rays(
    origin,  # (N, 3) world ray origin (camera position) of each env
    dirs,  # (N, P, 3) world ray directions
    shape_pos,  # (N, S, 3) world shape positions
    shape_quat,  # (N, S, 4)
    shape_size,  # (N, S, 3)
    kind,  # (N, S) int
    color,  # (N, S, 3)
    seg,  # (N, S)
    ground,  # (4,) [nx, ny, nz, d] or zeros when absent
    light_dir,  # (3,) unit, direction TOWARD the scene
    light_color,  # (3,)
    ambient,  # (3,)
    bg,  # (3,)
    tex=None,  # (T, R, R, 3) float atlas or None
    tex_id=None,  # (N, S) int, -1 = untextured
    mesh_rows=None,  # (Sm,) np indices of hull-rendered mesh shapes
    mesh_planes=None,  # (Sm, F, 4) local hull planes (unit-scale frame)
    mesh_base=None,  # (Sm, 3) build-time AABB halves (scale reference)
    tris=None,  # (tv_w (N,T,3,3), tn_w, tcol (N,T,3), tseg (T,), tsid (T,)) world-frame
    tri_excl=None,  # (S,) np bool: shapes rendered by `tris` instead
    lines=None,  # (seg_a (N,L,3), seg_b (N,L,3), col (N,L,3)) debug-draw overlay
    px_ang=None,  # (N,) pixel angular size (line thickness scale)
):
    """The raycast of N envs' rays (P = H*W a camera). Returns (rgba (N,P,4),
    t (N,P), hit (N,P), seg (N,P), best shape (N,P), hit_shape (N,P))."""
    N, P = dirs.shape[:2]
    S = shape_pos.shape[1]
    dev = dirs.device
    textured = tex is not None and tex_id is not None and tex.shape[0] > 0

    hull = None
    cols = S
    if mesh_rows is not None and len(mesh_rows) > 0:
        # mesh silhouettes: ray vs the convex hull. Runtime scale folds into
        # the planes: solid x' = sig*x => (n/sig).x' + d <= 0, renormalized.
        mr = torch.as_tensor(np.asarray(mesh_rows), dtype=torch.long, device=dev)
        base = torch.as_tensor(mesh_base, dtype=torch.float32, device=dev)
        planes = torch.as_tensor(mesh_planes, dtype=torch.float32, device=dev)
        sig = shape_size[:, mr] / base  # (N, Sm, 3)
        m = planes[..., :3] / sig[:, :, None, :]
        ln = _norm(m).clamp_min(1e-9)
        pl_s = torch.cat([m / ln[..., None], (planes[..., 3] / ln)[..., None]], -1)
        inv = np.zeros(S, np.int64)
        inv[np.asarray(mesh_rows)] = np.arange(len(mesh_rows))
        is_hull = np.zeros(S, bool)
        is_hull[np.asarray(mesh_rows)] = True
        hull = (mr, torch.as_tensor(inv, device=dev), torch.as_tensor(is_hull, device=dev), pl_s)
        cols += len(mesh_rows) * planes.shape[1]
    excl = None
    if tri_excl is not None and np.asarray(tri_excl).any():
        excl = torch.as_tensor(np.asarray(tri_excl), device=dev)

    # triangle and line passes per env over all of its rays
    tri_out = line_out = None
    if tris is not None and tris[0].shape[1] > 0:
        tv_w, tn_w, tcol_w, tseg_w, tsid_w = tris
        outs = [_ray_triangles(origin[i], dirs[i], tv_w[i], tn_w[i], tcol_w[i], tseg_w, tsid_w)
                for i in range(N)]
        tri_out = [torch.stack(parts, 0) for parts in zip(*outs)]
    if lines is not None and lines[0].shape[1] > 0:
        seg_a, seg_b, line_col = lines
        outs = []
        for i in range(N):
            tl, hl_, il = _ray_lines(origin[i], dirs[i], seg_a[i], seg_b[i], px_ang[i])
            outs.append((tl, hl_, line_col[i][il]))
        line_out = [torch.stack(parts, 0) for parts in zip(*outs)]

    rgba = torch.empty((N, P, 4), dtype=torch.float32, device=dev)
    t_out = torch.empty((N, P), dtype=torch.float32, device=dev)
    hit = torch.empty((N, P), dtype=torch.bool, device=dev)
    seg_img = torch.empty((N, P), dtype=seg.dtype, device=dev)
    best = torch.empty((N, P), dtype=torch.long, device=dev)
    hit_shape = torch.empty((N, P), dtype=torch.bool, device=dev)
    rays = max(1, min(P, BLOCK_ELEMS // cols))
    envs = max(1, BLOCK_ELEMS // (rays * cols))
    with span("render.primitives"):
        for e0 in range(0, N, envs):
            es = slice(e0, min(N, e0 + envs))
            h = None if hull is None else hull[:3] + (hull[3][es],)
            for r0 in range(0, P, rays):
                rs = slice(r0, min(P, r0 + rays))
                tri = None if tri_out is None else [x[es, rs] for x in tri_out]
                line = None if line_out is None else [x[es, rs] for x in line_out]
                out = _primitive_block(
                    origin[es], dirs[es, rs], shape_pos[es], shape_quat[es], shape_size[es],
                    kind[es], color[es], seg[es], ground, light_dir, light_color, ambient, bg,
                    tex if textured else None, tex_id[es] if textured else None, h, excl,
                    tri, line)
                for dst, src in zip((rgba, t_out, hit, seg_img, best, hit_shape), out):
                    dst[es, rs] = src
    return rgba, t_out, hit, seg_img, best, hit_shape


def _focal(props_w, hfov_deg):
    """The focal length in pixels of each env's camera, (N,)."""
    return props_w / 2 / torch.tan(hfov_deg * (math.pi / 180) / 2)


def _forward(quat):
    """The cameras' world forward axes (+x turned by quat), (N, 3)."""
    return quat_rotate(quat, const_rows((1.0, 0.0, 0.0), quat))


def camera_rays(props_w, props_h, hfov_deg, quat):
    """Pixel ray directions in WORLD frame. quat (N, 4) camera orientations;
    hfov_deg (N,) per-env horizontal fov. Returns (N, H*W, 3) and the
    forward axes (N, 3)."""
    with span("render.rays"):
        fx = _focal(props_w, hfov_deg)
        dev = quat.device
        u = torch.arange(props_w, dtype=torch.float32, device=dev) + 0.5 - props_w / 2
        v = torch.arange(props_h, dtype=torch.float32, device=dev) + 0.5 - props_h / 2
        vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W)
        f = fx[:, None, None]
        d_cam = torch.stack([torch.ones_like(uu).expand(f.shape[0], -1, -1), -uu / f, -vv / f],
                            -1).reshape(f.shape[0], -1, 3)
        d_cam = d_cam / _norm(d_cam, keepdim=True)
        d_w = quat_rotate(quat[:, None, :], d_cam)
        return d_w, _forward(quat)


def _t(x, dev, dtype=torch.float32):
    """x as a tensor of `dtype` on dev: a tensor there already or a Python
    number costs no host copy."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=dtype, device=dev)
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=dev).to(dtype)


def render_camera_batch(
    cam_pos,  # (N, 3) world
    cam_quat,  # (N, 4)
    shape_pos_w,  # (N, S, 3) world shape positions
    shape_quat_w,  # (N, S, 4)
    shape_size,  # (N, S, 3)
    kind,  # (S,)
    color,  # (S, 3) or (N, S, 3)
    seg,  # (S,)
    ground,  # (4,)
    light_dir,  # (3,)
    light_color,  # (3,)
    ambient,  # (3,)
    bg,  # (3,)
    hfov=90.0,  # scalar or (N,) per-env fov degrees
    tex=None,  # (T, R, R, 3) atlas (optional)
    tex_id=None,  # (S,) or (N, S) int, -1 untextured (optional)
    mesh_rows=None,  # (Sm,) np: hull-rendered mesh shapes
    mesh_planes=None,  # (Sm, F, 4) local hull planes
    mesh_base=None,  # (Sm, 3)
    body_lin=None,  # (N, S, 3) per-SHAPE body linear velocity (flow)
    body_ang=None,  # (N, S, 3)
    body_ctr=None,  # (N, S, 3) body origins (angular arm)
    tri_shape=None,  # (T,) np shape row per visual triangle
    tri_v=None,  # (T, 3, 3) local corner positions
    tri_n=None,  # (T, 3, 3) local corner normals
    tri_base=None,  # (S, 3) build-time shape sizes (scale ref)
    soft_tris=None,  # (N, Te, 3, 3) world-frame soft surface triangles
    soft_colors=None,  # (N, Te, 3) or (Te, 3) per-tri colors
    lines=None,  # (N, L, 2, 3) world debug-draw segments
    line_colors=None,  # (N, L, 3)
    *,
    width: int,
    height: int,
    far: float,
    ss: int = 1,
    cull_max: int = 256,
    flow_dt: float = 0.0,
):
    """Render N envs' cameras. Returns (rgba u8 (N,H,W,4), depth f32 (N,H,W),
    seg i32 (N,H,W), flow f32 (N,H,W,2) or None). depth is negative view
    depth, -inf for no hit. Per-env tensors are on the device the images
    come out on (cam_pos's); tables may be numpy.

    ss > 1 renders at (ss*H, ss*W) and box-downsamples (supersampling_h/v).
    Scenes with more than cull_max shapes are coarsely culled per env: the
    cull_max nearest shapes whose bounding sphere overlaps the view cone
    enter the ray loop (the mesh-hull, triangle, soft and line passes are
    skipped under culling; large culled scenes are ball worlds).

    flow_dt > 0 with body_lin/ang/ctr given produces IMAGE_OPTICAL_FLOW:
    per-pixel (du, dv) in PIXELS between the previous frame (hit points
    reprojected back by their body velocity x dt) and this one."""
    with span("render"):
        dev = cam_pos.device
        N, S = shape_pos_w.shape[:2]
        color = _t(color, dev)
        color = color.expand(N, S, 3) if color.dim() == 2 else color
        kind = _t(kind, dev, torch.int32).expand(N, S)
        seg = _t(seg, dev, torch.int32).expand(N, S)
        hfov = _t(hfov, dev).expand(N)
        ground, light_dir, light_color, ambient, bg = (
            _t(x, dev) for x in (ground, light_dir, light_color, ambient, bg))
        do_cull = S > cull_max
        if tex is not None:
            tex = _t(tex, dev)
        if tex_id is not None:
            tex_id = _t(tex_id, dev, torch.int32).expand(N, S)
        rw, rh = width * ss, height * ss

        want_flow = flow_dt > 0 and body_lin is not None
        use_mesh = mesh_rows is not None and len(mesh_rows) > 0 and not do_cull
        use_tris = tri_shape is not None and len(tri_shape) > 0 and not do_cull
        use_soft = soft_tris is not None and soft_tris.shape[1] > 0 and not do_cull
        use_lines = lines is not None and lines.shape[1] > 0 and not do_cull

        sp, sq, ssize = shape_pos_w, shape_quat_w, shape_size
        col_k, kind_k, seg_k, tid_k = color, kind, seg, tex_id
        if do_cull:
            # bounding sphere vs view cone (conservative): keep the cull_max
            # nearest shapes that can intersect the frustum, in a stable order
            fwd0 = _forward(cam_quat)
            rel = sp - cam_pos[:, None, :]
            dist = _norm(rel)
            rad = _norm(ssize)
            along = _dot(rel, fwd0[:, None, :])
            perp = torch.sqrt((dist ** 2 - along ** 2).clamp_min(0.0))
            # half-diagonal of the image plane at unit distance
            t_half = torch.tan(hfov * (math.pi / 180) / 2)
            diag = t_half * torch.sqrt(_t(1.0 + (height / width) ** 2, dev)) + 1e-3
            visible = (along + rad > 0) & (perp - rad <= along.clamp_min(0.0) * diag[:, None] + rad)
            score = torch.where(visible, dist - rad, BIG)
            keep = torch.sort(score, dim=-1, stable=True).indices[:, :cull_max]
            sp, sq, ssize = _take(sp, keep), _take(sq, keep), _take(ssize, keep)
            col_k, kind_k, seg_k = _take(color, keep), _take(kind, keep), _take(seg, keep)
            tid_k = _take(tex_id, keep) if tex_id is not None else None
        textured = tex is not None and tex_id is not None and tex.shape[0] > 0
        if _kernel_frame(dev, ss, textured, use_mesh, use_tris, use_soft, use_lines, want_flow):
            with span("render.rays"):
                fx, fwd = _focal(rw, hfov), _forward(cam_quat)
            with span("render.primitives"):
                return _raycast_cuda(cam_pos, cam_quat, fx, fwd, sp, sq, ssize, kind_k, col_k,
                                     seg_k, ground, light_dir, light_color, ambient, bg,
                                     width=width, height=height, far=far) + (None,)
        dirs, fwd = camera_rays(rw, rh, hfov, cam_quat)

        tris = tri_excl = None
        if use_tris or use_soft:
            parts_v, parts_n, parts_c, parts_s, parts_i = [], [], [], [], []
            if use_tris:
                ts_np = np.asarray(tri_shape)
                tri_excl = np.zeros(S, bool)
                tri_excl[ts_np] = True
                ts = torch.as_tensor(ts_np, dtype=torch.long, device=dev)
                base = _t(np.maximum(np.asarray(tri_base, np.float32)[ts_np], 1e-6), dev)
                # world transform of the local tri table; nonuniform runtime
                # scale sig maps normals through 1/sig
                sig = ssize[:, ts] / base  # (N, T, 3)
                qts = sq[:, ts][:, :, None, :]
                parts_v.append(sp[:, ts][:, :, None, :]
                               + quat_rotate(qts, sig[:, :, None, :] * _t(tri_v, dev)))
                parts_n.append(quat_rotate(qts, _t(tri_n, dev) / sig[:, :, None, :]))
                parts_c.append(col_k[:, ts])
                parts_s.append(seg_k[0, ts])
                parts_i.append(ts.to(torch.int32))
            if use_soft:
                stris = _t(soft_tris, dev)
                Te = stris.shape[1]
                parts_v.append(stris)
                fn = cross(stris[:, :, 1] - stris[:, :, 0], stris[:, :, 2] - stris[:, :, 0])
                parts_n.append(fn[:, :, None, :].expand(N, Te, 3, 3))
                parts_c.append(_t(soft_colors, dev).expand(N, Te, 3))
                parts_s.append(torch.zeros(Te, dtype=torch.int32, device=dev))
                parts_i.append(torch.full((Te,), -1, dtype=torch.int32, device=dev))
            tris = tuple(torch.cat(x, 1 if k < 3 else 0)
                         for k, x in enumerate((parts_v, parts_n, parts_c, parts_s, parts_i)))
        lns = None
        if use_lines:
            lt = _t(lines, dev)
            lns = (lt[:, :, 0], lt[:, :, 1], _t(line_colors, dev))
        rgba, t, hit, seg_img, best, hit_shape = render_rays(
            cam_pos, dirs, sp, sq, ssize, kind_k, col_k, seg_k,
            ground, light_dir, light_color, ambient, bg,
            tex=tex, tex_id=tid_k,
            mesh_rows=mesh_rows if use_mesh else None,
            mesh_planes=mesh_planes if use_mesh else None,
            mesh_base=mesh_base if use_mesh else None,
            tris=tris, tri_excl=tri_excl, lines=lns,
            px_ang=2.0 * torch.tan(hfov * (math.pi / 180) / 2) / rw,
        )
        with span("render.pack"):
            zdepth = t * _dot(dirs, fwd[:, None, :])
            depth = torch.where(hit & (t < far), -zdepth, -math.inf)
            flow = None
            if want_flow:
                bl, ba, bc = (_t(x, dev) for x in (body_lin, body_ang, body_ctr))
                p_hit = cam_pos[:, None, :] + t[..., None] * dirs
                v_hit = _take(bl, best) + cross(_take(ba, best), p_hit - _take(bc, best))
                v_hit = torch.where(hit_shape[..., None], v_hit, 0.0)
                p_prev = p_hit - flow_dt * v_hit
                dc = quat_rotate_inverse(cam_quat[:, None, :], p_prev - cam_pos[:, None, :])
                fx = (rw / 2 / torch.tan(hfov * (math.pi / 180) / 2))[:, None]
                x = dc[..., 0].clamp_min(1e-6)
                u_prev = -dc[..., 1] / x * fx + rw / 2 - 0.5
                v_prev = -dc[..., 2] / x * fx + rh / 2 - 0.5
                vv, uu = torch.meshgrid(torch.arange(rh, dtype=torch.float32, device=dev),
                                        torch.arange(rw, dtype=torch.float32, device=dev),
                                        indexing="ij")
                du = uu.reshape(-1) - u_prev
                dv = vv.reshape(-1) - v_prev
                flow = torch.where(hit_shape[..., None], torch.stack([du, dv], -1), 0.0)
                flow = flow.reshape(N, rh, rw, 2)
            rgba = rgba.reshape(N, rh, rw, 4)
            depth = depth.reshape(N, rh, rw)
            seg_img = seg_img.reshape(N, rh, rw)
            if ss > 1:  # box filter downsample
                rgba = rgba.reshape(N, height, ss, width, ss, 4).mean((2, 4))
                depth = depth.reshape(N, height, ss, width, ss).amax((2, 4))
                seg_img = seg_img.reshape(N, height, ss, width, ss)[:, :, 0, :, 0]
                if flow is not None:
                    flow = flow.reshape(N, height, ss, width, ss, 2).mean((2, 4)) / ss
            return (rgba * 255).to(torch.uint8), depth, seg_img.to(torch.int32), flow


def _kernel_frame(dev, ss, *passes) -> bool:
    """Whether a frame goes to csrc/raycast.cu: on a CUDA device, at ss 1,
    asking for no pass but the primitive one (`passes`: texture, hull rows,
    triangles, soft triangles, lines, optical flow). Every other frame runs
    the plain ops."""
    return dev.type == "cuda" and ss == 1 and not any(passes)


_P = ctypes.c_void_p
_ARGTYPES = (
    [_P] * 15  # the inputs, in _raycast_cuda's order
    + [ctypes.c_float] + [ctypes.c_int] * 4  # far N S W H
    + [_P] * 3  # rgba depth seg_img
    + [_P]  # stream
)


def _raycast_cuda(cam_pos, cam_quat, focal, forward, sp, sq, ssize, kind, color, seg, ground,
                  light_dir, light_color, ambient, sky, *, width, height, far):
    """One launch of csrc/raycast.cu on the current stream: the frame
    `render_camera_batch` renders with the primitive pass alone, as (rgba u8
    (N, H, W, 4), depth (N, H, W), seg i32 (N, H, W)). focal (N,) and forward
    (N, 3) are `_focal`'s and `_forward`'s. Takes float32 CUDA tensors of one
    device (kind and seg int32) and raises on anything else."""
    N, S = sp.shape[:2]
    dev = cam_pos.device
    args = _kernels.inputs("raycast", dev, (
        ("cam_pos", cam_pos, (N, 3)), ("cam_quat", cam_quat, (N, 4)), ("focal", focal, (N,)),
        ("forward", forward, (N, 3)), ("shape_pos", sp, (N, S, 3)),
        ("shape_quat", sq, (N, S, 4)), ("shape_size", ssize, (N, S, 3)),
        ("kind", kind, (N, S), torch.int32), ("color", color, (N, S, 3)),
        ("seg", seg, (N, S), torch.int32), ("ground", ground, (4,)),
        ("light_dir", light_dir, (3,)), ("light_color", light_color, (3,)),
        ("ambient", ambient, (3,)), ("sky", sky, (3,))))
    rgba = torch.empty((N, height, width, 4), dtype=torch.uint8, device=dev)
    depth = torch.empty((N, height, width), dtype=torch.float32, device=dev)
    seg_img = torch.empty((N, height, width), dtype=torch.int32, device=dev)
    if rgba.numel():  # no pixel: nothing to launch
        _kernels.launch("raycast", _kernels.entry("raycast", "raycast_forward", _ARGTYPES), dev,
                        *(a.data_ptr() for a in args), far, N, S, width, height,
                        rgba.data_ptr(), depth.data_ptr(), seg_img.data_ptr())
    return rgba, depth, seg_img


def shape_world_poses(state, params, tables: RenderTables, scene: Scene):
    """World pose of every shape: (N, S, 3), (N, S, 4). Tables already on
    the state's device (`RenderTables.to`) make no host copy."""
    with span("render.poses"):
        dev = state.body_pos.device
        body = torch.as_tensor(tables.body, device=dev).long()
        bq = state.body_quat[:, body]
        bp = state.body_pos[:, body]
        sp = bp + quat_rotate(bq, params.shape_pos)
        sq = quat_mul(bq, torch.as_tensor(tables.quat, device=dev))
        return sp, sq

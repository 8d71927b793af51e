"""Port parity: the ray-cast renderer (render/raster.py, render/meshtools.py)
and CameraSensor (render/camera.py) against the JAX package.

The cases of tests/test_render.py, called directly on scenes built by each
package's SceneBuilder, not through the facade: a checker texture, a
per-env fov, supersampling, the frustum cull against no cull, a convex mesh
rendered as its hull, optical flow, a concave visual mesh against its hull,
debug lines, flat against smooth normals; and the soft icosphere's surface
(the pedestal scene of envs/soft_body.py). Each scene goes through both
packages' `tables_from_scene`, `shape_world_poses` and
`render_camera_batch` with the same numpy inputs, and each case keeps its
own behavioural assertion from test_render.py on the port's image.

Rule (`assert_images_match`): where both depths are finite they agree
within 1e-4 * max(|d|, 1); segmentation and hit/miss are equal and the
colour within one count, except on at most SILHOUETTE_SHARE of the pixels,
all of them at a silhouette of the JAX image (a change of segmentation,
hit/miss or a relative depth jump over 2% next to them): a ray that grazes
an edge may hit in one package and miss in the other when the two round
the last bits of its distance apart.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_isaacgym_tpu  # noqa: F401  (CPU platform before jax init)
from test_isaacgym_tpu.render import raster as jr
from test_isaacgym_tpu.render.camera import CameraSensor as JaxCamera
from test_isaacgym_tpu_torch.render import camera as tcam
from test_isaacgym_tpu_torch.render import raster as tr

JAX, TORCH = "test_isaacgym_tpu", "test_isaacgym_tpu_torch"
SILHOUETTE_SHARE = 0.01
LIGHT = dict(
    ground=np.array([0, 0, 1, 0], np.float32),
    light_dir=np.array([-0.3, -0.3, -0.9], np.float32) / np.linalg.norm([0.3, 0.3, 0.9]),
    light_color=np.full(3, 0.8, np.float32),
    ambient=np.full(3, 0.25, np.float32),
    bg=np.array([0.32, 0.45, 0.6], np.float32),
)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def build(pkg, fill, sim_params=None):
    """A Simulator of `pkg` whose builder `fill(builder, pkg)` filled."""
    cfg = _mod(pkg, "core.config")
    b = _mod(pkg, "core.scene").SceneBuilder(sim_params or cfg.SimParams())
    fill(b, pkg)
    Sim = _mod(pkg, "core.sim").Simulator
    return Sim(*b.finalize()) if pkg == JAX else Sim(*b.finalize("cpu"), device="cpu")


def balls(num_envs=2, z=1.0, radius=0.2):
    def fill(b, pkg):
        b.add_ground(_mod(pkg, "core.config").PlaneParams())
        ball = _mod(pkg, "assets.primitives").create_sphere(radius, density=100.0)
        for i in range(num_envs):
            b.create_env((-1, -1, 0), (1, 1, 2), 2)
            b.create_actor(i, ball, pos=(0, 0, z), name="ball", group=i, filter=0,
                           seg_id=7)
    return fill


def mesh_actor(verts, faces, z=1.0, normal_mode=None):
    def fill(b, pkg):
        a = _mod(pkg, "assets.primitives").create_mesh_asset(
            "m", verts, faces, density=100.0, fix_base_link=True)
        if normal_mode is not None:
            a.mesh_normal_mode = normal_mode
        b.create_env((-1, -1, 0), (1, 1, 2), 1)
        b.create_actor(0, a, pos=(0, 0, z), name="m", group=0, filter=0, seg_id=3)
    return fill


OCTA_V = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                  np.float32) * 0.3
OCTA_F = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5], [3, 1, 5],
                   [0, 3, 5]], np.int32)


def l_prism():
    """test_render.py's L-shaped prism: outline (0,0)-(2,0)-(2,1)-(1,1)-(1,2)-
    (0,2) x 0.3 in the xz plane, extruded along y."""
    out2d = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], np.float32) * 0.3
    tris2d = [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 5]]
    v = np.asarray([[p[0], y, p[1]] for y in (-0.15, 0.15) for p in out2d], np.float32)
    f = [list(t) for t in tris2d] + [[a + 6, c + 6, b + 6] for a, b, c in tris2d]
    for i in range(6):
        j = (i + 1) % 6
        f += [[i, j, 6 + j], [i, 6 + j, 6 + i]]
    return v, np.asarray(f, np.int32)


def poses(pkg, sim):
    """(tables, shape positions, quats, sizes) of a package's sim as numpy."""
    r = jr if pkg == JAX else tr
    tb = r.tables_from_scene(sim.scene)
    sp, sq = r.shape_world_poses(sim.state, sim.params, tb, sim.scene)
    size = sim.params.shape_size
    if pkg == TORCH:
        sp, sq, size = sp.numpy(), sq.numpy(), size.numpy()
    return tb, np.asarray(sp), np.asarray(sq), np.asarray(size)


def cameras(sim, eyes, targets):
    """World camera poses (N, 3), (N, 4) of env-local eyes and targets."""
    org = np.asarray(sim.scene.env_origins, np.float32)
    pos = np.asarray(eyes, np.float32) + org
    quat = np.stack([tcam.look_at_quat(e, t) for e, t in zip(eyes, targets)]).astype(np.float32)
    return pos, quat


def render(pkg, cam_pos, cam_quat, sp, sq, size, tb, **kw):
    """One package's render_camera_batch; numpy (rgba, depth, seg, flow)."""
    args = dict(LIGHT)
    args.update(kw.pop("light", {}))
    width, height, far = kw.pop("width"), kw.pop("height"), kw.pop("far", 100.0)
    static = {k: kw.pop(k) for k in ("ss", "cull_max", "flow_dt") if k in kw}
    color = kw.pop("color", tb.color)
    if pkg == JAX:
        for k in ("mesh_rows", "tri_shape"):
            if k in kw:
                kw[k] = tuple(int(x) for x in kw[k])
        if "tri_base" in kw:
            kw["tri_base"] = tuple(tuple(float(x) for x in row) for row in kw["tri_base"])
        out = jr.render_camera_batch(
            cam_pos, cam_quat, sp, sq, size, tb.kind, color, tb.seg, args["ground"],
            args["light_dir"], args["light_color"], args["ambient"], args["bg"],
            width=width, height=height, far=far, **static, **kw)
        return tuple(None if x is None else np.asarray(x) for x in out)
    t = lambda x: None if x is None else torch.as_tensor(np.asarray(x))  # noqa: E731
    for k in ("body_lin", "body_ang", "body_ctr", "soft_tris", "lines", "line_colors", "tex"):
        if k in kw:
            kw[k] = t(kw[k])
    out = tr.render_camera_batch(
        t(cam_pos), t(cam_quat), t(sp), t(sq), t(size), tb.kind, color, tb.seg, args["ground"],
        args["light_dir"], args["light_color"], args["ambient"], args["bg"],
        width=width, height=height, far=far, **static, **kw)
    return tuple(None if x is None else x.numpy() for x in out)


def mesh_kw(tb, sim):
    kw = dict(mesh_rows=tb.mesh_rows, mesh_planes=tb.mesh_planes, mesh_base=tb.mesh_base)
    if len(tb.tri_shape):
        kw.update(tri_shape=tb.tri_shape, tri_v=tb.tri_v, tri_n=tb.tri_n,
                  tri_base=np.asarray(sim.scene.shapes.size, np.float32))
    return kw


def both(fill, eyes, targets, sim_params=None, extra=None, **kw):
    """Render one scene in both packages; returns (port images, JAX images,
    port sim)."""
    out = {}
    for pkg in (JAX, TORCH):
        sim = build(pkg, fill, sim_params)
        tb, sp, sq, size = poses(pkg, sim)
        cp, cq = cameras(sim, eyes, targets)
        args = dict(kw)
        if sim.scene.ground is None:
            args["light"] = dict(kw.get("light", {}), ground=np.zeros(4, np.float32))
        if extra is not None:
            args.update(extra(pkg, sim, tb))
        out[pkg] = render(pkg, cp, cq, sp, sq, size, tb, **args), sim
    return out[TORCH][0], out[JAX][0], out[TORCH][1]


def silhouettes(seg, depth):
    """Pixels of an image next to (or at) a change of segmentation, hit/miss
    or a relative depth jump over 2%."""
    fin = np.isfinite(depth)
    d = np.where(fin, depth, 0.0)
    edge = np.zeros(seg.shape, bool)
    for axis in (-1, -2):
        s0 = np.swapaxes(seg, axis, -1)
        f0, d0 = np.swapaxes(fin, axis, -1), np.swapaxes(d, axis, -1)
        jump = ((s0[..., 1:] != s0[..., :-1]) | (f0[..., 1:] != f0[..., :-1])
                | (np.abs(d0[..., 1:] - d0[..., :-1])
                   > 0.02 * np.maximum(np.abs(d0[..., 1:]), 1e-6)))
        e = np.zeros(s0.shape, bool)
        e[..., 1:] |= jump
        e[..., :-1] |= jump
        edge |= np.swapaxes(e, axis, -1)
    # one pixel more on every side
    grown = edge.copy()
    grown[..., 1:, :] |= edge[..., :-1, :]
    grown[..., :-1, :] |= edge[..., 1:, :]
    grown[..., :, 1:] |= edge[..., :, :-1]
    grown[..., :, :-1] |= edge[..., :, 1:]
    return grown


def assert_images_match(got, want, share=SILHOUETTE_SHARE):
    (rgba, depth, seg), (w_rgba, w_depth, w_seg) = got[:3], want[:3]
    assert rgba.shape == w_rgba.shape and rgba.dtype == np.uint8
    fin, w_fin = np.isfinite(depth), np.isfinite(w_depth)
    both_fin = fin & w_fin
    dd = np.abs(np.where(both_fin, depth, 0.0) - np.where(both_fin, w_depth, 0.0))
    bad = (seg != w_seg) | (fin != w_fin)
    bad |= dd > 1e-4 * np.maximum(np.abs(np.where(both_fin, w_depth, 0.0)), 1.0)
    bad |= np.abs(rgba.astype(np.int32) - w_rgba.astype(np.int32)).max(-1) > 1
    off = bad & ~silhouettes(w_seg, w_depth)
    assert not off.any(), f"{int(off.sum())} pixels differ away from a silhouette"
    assert bad.mean() <= share, f"{bad.mean():.4f} of the pixels differ (> {share})"


def test_texture_sampling():
    """A red/blue checker on env 0's ball shows both colors there and
    neither in the untextured env 1."""
    buf = np.zeros((8, 8, 4), np.uint8)
    buf[:, :4] = [255, 30, 30, 255]
    buf[:, 4:] = [30, 30, 255, 255]
    tex = tr.resample_texture(buf)[None]
    np.testing.assert_array_equal(tex[0], jr.resample_texture(buf))
    eyes, tgts = [(1.0, 0, 1)] * 2, [(0, 0, 1)] * 2
    got, want, _ = both(balls(), eyes, tgts, width=64, height=48, tex=tex,
                        tex_id=np.array([[0], [-1]], np.int32))
    assert_images_match(got, want)
    img0, img1 = got[0][0].astype(np.int32), got[0][1].astype(np.int32)
    assert (img0[..., 0] > img0[..., 2] + 40).sum() > 20
    assert (img0[..., 2] > img0[..., 0] + 40).sum() > 20
    ball = np.isfinite(got[1][1]) & (got[1][1] > -1.2)
    assert ball.sum() > 50
    assert (np.abs(img1[..., 0] - img1[..., 2])[ball] > 40).sum() == 0


def test_per_env_fov_zoom():
    """A 20 degree fov in env 1 makes the ball cover more pixels than the
    default 90 degrees in env 0."""
    eyes, tgts = [(2, 0, 1)] * 2, [(0, 0, 1)] * 2
    got, want, _ = both(balls(), eyes, tgts, width=64, height=48,
                        hfov=np.array([90.0, 20.0], np.float32))
    assert_images_match(got, want)
    n0, n1 = (got[2][0] == 7).sum(), (got[2][1] == 7).sum()
    assert n0 > 3 and n1 > 3 * n0, (n0, n1)


def test_supersampling_smooths_edges():
    eyes, tgts = [(2, 0, 1)], [(0, 0, 1)]
    one, _, _ = both(balls(1), eyes, tgts, width=48, height=36)
    got, want, _ = both(balls(1), eyes, tgts, width=48, height=36, ss=4)
    assert_images_match(got, want)
    assert got[0].shape == one[0].shape
    assert len(np.unique(got[0][..., 0])) > len(np.unique(one[0][..., 0]))


def test_frustum_cull_matches_uncull():
    """400 spheres, 220 behind the camera: the culled render (cull_max 256)
    equals the unculled one, in the port as in the JAX package."""
    rng = np.random.RandomState(0)
    S = 400
    sp = rng.uniform(-5, 5, (1, S, 3)).astype(np.float32)
    sp[..., 2] = rng.uniform(0.2, 3, (1, S))
    sp[0, 180:, 0] = rng.uniform(12.0, 20.0, 220)
    sq = np.tile(np.array([0, 0, 0, 1], np.float32), (1, S, 1))
    ssz = np.tile(np.array([0.15, 0.0, 0.0], np.float32), (1, S, 1))
    tb = tr.RenderTables(
        body=None, kind=np.zeros(S, np.int32), quat=None,
        color=rng.uniform(0.2, 0.9, (S, 3)).astype(np.float32),
        seg=np.arange(1, S + 1, dtype=np.int32), mesh_rows=None, mesh_planes=None,
        mesh_base=None, tri_shape=None, tri_v=None, tri_n=None)
    cam = (np.array([[8.0, 0, 2]], np.float32), np.array([[0, 0, 1, 0]], np.float32))
    light = dict(light_dir=np.array([0.3, 0.3, -0.9], np.float32) / np.linalg.norm([0.3, 0.3, 0.9]),
                 light_color=np.ones(3, np.float32) * 0.8, ambient=np.ones(3, np.float32) * 0.2,
                 bg=np.array([0.3, 0.4, 0.6], np.float32))
    kw = dict(width=64, height=48, hfov=60.0, light=light)
    full = render(TORCH, *cam, sp, sq, ssz, tb, cull_max=512, **kw)
    culled = render(TORCH, *cam, sp, sq, ssz, tb, cull_max=256, **kw)
    np.testing.assert_array_equal(full[0], culled[0])
    np.testing.assert_array_equal(full[2], culled[2])
    want = render(JAX, *cam, sp, sq, ssz, tb, cull_max=256, **kw)
    assert_images_match(culled, want)


def test_mesh_renders_as_hull_not_box():
    """An octahedron renders as its hull: its silhouette covers well under
    the bounding box of its hits."""
    got, want, _ = both(mesh_actor(OCTA_V, OCTA_F), [(1.2, 0, 1.0)], [(0, 0, 1.0)], width=96,
                        height=96, extra=lambda pkg, sim, tb: dict(
                            mesh_rows=tb.mesh_rows, mesh_planes=tb.mesh_planes,
                            mesh_base=tb.mesh_base))
    assert_images_match(got, want)
    d = got[1][0]
    hit = np.isfinite(d) & (d > -2.0)
    assert hit.sum() > 100
    assert hit.sum() < 0.72 * hit.any(0).sum() * hit.any(1).sum()


def test_optical_flow():
    """A ball moving +y across the camera: horizontal flow of one sign on
    the ball, zero on the background."""
    def extra(pkg, sim, tb):
        body = np.asarray(tb.body)
        st = sim.state
        lin = np.asarray(st.body_linvel if pkg == JAX else st.body_linvel.numpy()).copy()
        lin[:, :, 1] = 2.0
        ang = np.zeros_like(lin)
        ctr = np.asarray(st.body_pos if pkg == JAX else st.body_pos.numpy())
        return dict(body_lin=lin[:, body], body_ang=ang[:, body], body_ctr=ctr[:, body],
                    flow_dt=1 / 60)

    got, want, _ = both(balls(1), [(1.5, 0, 1.0)], [(0, 0, 1.0)], width=64, height=48,
                        extra=extra)
    assert_images_match(got, want)
    flow, d = got[3][0], got[1][0]
    fin = np.isfinite(d) & np.isfinite(want[1][0])
    np.testing.assert_allclose(flow[fin], want[3][0][fin], atol=1e-3)
    ball = np.isfinite(d) & (d > -1.45) & (d < -1.1)
    ball[28:] = False
    assert ball.sum() > 30
    du = flow[..., 0][ball]
    assert np.abs(du).mean() > 0.5
    assert (np.sign(du) == np.sign(du.mean())).mean() > 0.9
    assert np.abs(flow[..., 0][~np.isfinite(d)]).max() < 1e-4


def test_concave_mesh_silhouette_differs_from_hull():
    """The L-prism's notch shows: rays through it miss the visual mesh."""
    v, f = l_prism()
    got, want, _ = both(mesh_actor(v, f), [(0.3, 1.2, 1.3)], [(0.3, 0, 1.3)], width=96,
                        height=96, extra=lambda pkg, sim, tb: mesh_kw(tb, sim))
    assert_images_match(got, want)
    d = got[1][0]
    hit = np.isfinite(d) & (d > -2.5)
    assert hit.sum() > 200
    rows, cols = np.where(hit.any(1))[0], np.where(hit.any(0))[0]
    r0, r1, c0, c1 = rows.min(), rows.max(), cols.min(), cols.max()
    rm, cm = (r0 + r1) // 2, (c0 + c1) // 2
    lo, hi = sorted([hit[r0:rm, c0:cm].mean(), hit[r0:rm, cm:c1].mean()])
    assert lo < 0.25 and hi > 0.7, (lo, hi)


def test_lines_rasterize():
    """A red debug line across the ball changes pixels to its color."""
    lines = np.array([[[[0, -0.6, 1.0], [0, 0.6, 1.0]]]], np.float32)
    cols = np.array([[[1.0, 0.0, 0.0]]], np.float32)

    def extra(pkg, sim, tb):
        org = np.asarray(sim.scene.env_origins, np.float32)
        return dict(lines=lines + org[:, None, None, :], line_colors=cols)

    base, _, _ = both(balls(1), [(1.5, 0, 1.0)], [(0, 0, 1.0)], width=96, height=64)
    got, want, _ = both(balls(1), [(1.5, 0, 1.0)], [(0, 0, 1.0)], width=96, height=64,
                        extra=extra)
    assert_images_match(got, want)
    changed = (got[0] != base[0]).any(-1)
    assert changed.sum() > 10
    px = got[0][changed]
    assert (px[:, 0].astype(int) > px[:, 1].astype(int) + 40).mean() > 0.8


@pytest.mark.parametrize("mode", [0, 1])
def test_mesh_normal_mode_flat_vs_smooth(mode):
    """COMPUTE_PER_VERTEX (0) smooth-shades the visual mesh, FROM_ASSET (1)
    flat-shades it; each like the JAX package, and smooth shows more
    shades."""
    imgs = {}
    for m in (0, 1):
        got, want, _ = both(mesh_actor(OCTA_V, OCTA_F, normal_mode=m), [(1.0, 0.4, 1.2)],
                            [(0, 0, 1.0)], width=64, height=64,
                            extra=lambda pkg, sim, tb: mesh_kw(tb, sim))
        if m == mode:
            assert_images_match(got, want)
        imgs[m] = got[0][0, ..., 0]
    assert len(np.unique(imgs[0])) > len(np.unique(imgs[1])) + 8


def test_soft_surface_renders():
    """The pedestal scene's three soft icospheres render from their surface
    triangles (soft_tris), as in the JAX package."""
    from test_isaacgym_tpu_torch.envs import soft_body as sb

    def fill(b, pkg):
        sb.build_pedestals(b, _mod(pkg, "core.config"), _mod(pkg, "assets.primitives"),
                           sb.icosphere(_mod(pkg, "assets").load_urdf, sb.PEDESTAL_THICKNESS))

    def extra(pkg, sim, tb):
        pos = np.asarray(sim.state.soft_pos if pkg == JAX else sim.state.soft_pos.numpy())
        return dict(soft_tris=pos[:, np.asarray(sim.scene.soft.tris)],
                    soft_colors=np.asarray([0.82, 0.45, 0.35], np.float32), **mesh_kw(tb, sim))

    cfg = _mod(TORCH, "core.config")
    got, want, _ = both(fill, [(3.0, -3.0, 2.5)], [(0, 0, 1.0)], width=96, height=72,
                        sim_params=sb.soft_params(cfg, up_y=False), extra=extra)
    assert_images_match(got, want)
    soft = (np.abs(got[0][0, ..., :3].astype(int) - [209, 114, 89]).sum(-1) < 120)
    assert np.isfinite(got[1][0]).mean() > 0.5 and soft.sum() > 20


def test_render_is_the_same_in_blocks():
    """The primitive pass in blocks of a few rays gives the bits of one
    block."""
    eyes, tgts = [(1.0, 0, 1)] * 2, [(0, 0, 1)] * 2
    sim = build(TORCH, balls())
    tb, sp, sq, size = poses(TORCH, sim)
    cp, cq = cameras(sim, eyes, tgts)
    one = render(TORCH, cp, cq, sp, sq, size, tb, width=32, height=24)
    saved = tr.BLOCK_ELEMS
    tr.BLOCK_ELEMS = 100
    try:
        many = render(TORCH, cp, cq, sp, sq, size, tb, width=32, height=24)
    finally:
        tr.BLOCK_ELEMS = saved
    for a, b in zip(one[:3], many[:3]):
        np.testing.assert_array_equal(a, b)


def test_camera_sensor_poses():
    """Free poses, set_location, per-env fov, attach (both follow modes),
    world/env poses and the view matrix like the JAX CameraSensor; the
    batched look-at like look_at_quat."""
    from test_isaacgym_tpu.core.config import CameraProperties as JaxProps
    from test_isaacgym_tpu_torch.core.config import CameraProperties

    sims = {pkg: build(pkg, balls(3)) for pkg in (JAX, TORCH)}
    org = np.asarray(sims[TORCH].scene.env_origins, np.float32)
    jc = JaxCamera(props=JaxProps(width=64, height=48), num_envs=1)
    tc = tcam.CameraSensor(props=CameraProperties(width=64, height=48), num_envs=1, device="cpu")
    for c in (jc, tc):
        c.set_location(2, (1.5, 0.2, 1.1), (0, 0, 0.9))
        c.set_location(0, (0.3, -1.0, 2.0), (0.1, 0.1, 0.5))
        c.set_transform(1, (0.5, 0.5, 0.5), (0, 0, np.sin(0.3), np.cos(0.3)))
        c.set_horizontal_fov(2, 30.0)
    np.testing.assert_array_equal(tc.fov_per_env, jc.fov_per_env)

    def pose_pair():
        jp, jq = jc.world_pose(sims[JAX].state, jnp.asarray(org))
        tp, tq = tc.world_pose(sims[TORCH].state, torch.as_tensor(org))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
        je = jc.env_pose(sims[JAX].state, jnp.asarray(org))[0]
        np.testing.assert_allclose(tc.env_pose(sims[TORCH].state, torch.as_tensor(org))[0].numpy(),
                                   np.asarray(je), atol=1e-6)
        np.testing.assert_allclose(tc.view_matrix(sims[TORCH].state, torch.as_tensor(org), 2),
                                   jc.view_matrix(sims[JAX].state, jnp.asarray(org), 2), atol=1e-6)

    pose_pair()
    for mode in (tcam.FOLLOW_TRANSFORM, tcam.FOLLOW_POSITION):
        for c in (jc, tc):
            c.attach(0, (0.1, 0.0, 0.3), (0, np.sin(0.2), 0, np.cos(0.2)), follow_mode=mode)
        pose_pair()
    np.testing.assert_allclose(tc.proj_matrix(), jc.proj_matrix())

    rng = np.random.RandomState(3)
    eye = rng.uniform(-3, 3, (16, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    tgt[0] = eye[0] + [0, 0, 2.0]  # along up: the other up axis
    got = tcam.look_at_quat_t(torch.as_tensor(eye), torch.as_tensor(tgt)).numpy()
    want = np.stack([tcam.look_at_quat(e, t) for e, t in zip(eye, tgt)])
    np.testing.assert_allclose(np.abs((got * want).sum(-1)), 1.0, atol=1e-5)
    tc.set_locations(torch.as_tensor(eye[:3]), torch.as_tensor(tgt[:3]))
    assert tc.body is None
    np.testing.assert_allclose(tc.world_pose(sims[TORCH].state, torch.as_tensor(org))[0].numpy(),
                               eye[:3] + org, atol=1e-6)


def test_nut_scene_frame_matches_golden(tmp_path, monkeypatch):
    """One env of the port's FrankaNutBoltEnv scene (the arm's boxes, the nut
    stand-in's visual mesh by the triangle pass, its hull) at 160 x 90 from
    bench.py's render camera against render_standin.npz, the JAX package's
    frame of the same scene (tools/make_rl_goldens.py)."""
    import chip_smoke
    import test_isaacgym_tpu_torch.assets.sdf as tsdf
    from test_isaacgym_tpu_torch.envs.franka_nut_bolt import FrankaNutBoltEnv

    monkeypatch.setattr(tsdf, "_CACHE_DIR", str(tmp_path))
    sim = FrankaNutBoltEnv(num_envs=1, device="cpu").sim
    tb = tr.tables_from_scene(sim.scene)
    assert len(tb.tri_shape) and len(tb.mesh_rows)
    g = np.load(chip_smoke.port_data("render_standin.npz"))
    out = chip_smoke.nut_scene_render(tr, sim, tb, *chip_smoke.RENDER_SMALL,
                                      np.arange(1, len(tb.kind) + 1, dtype=np.int32))
    got = tuple(x[0].numpy() for x in out)
    assert_images_match(got, (g["rgba"], g["depth"], g["seg"]))
    assert len(np.unique(g["seg"])) > 3

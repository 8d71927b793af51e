"""csrc/raycast.cu, the renderer's primitive pass, against the plain ops.

The CPU tests hold the routing: CPU frames take the plain ops of
render/raster.py and never build or load the kernel, the wrapper refuses
what the kernel does not take before any library is loaded, and a frame that
asks for any pass but the primitive one (a texture, hull rows, triangles,
soft triangles, lines, optical flow, supersampling) goes to the plain ops
on the card too. The `cuda` tests, which run only where a CUDA
device is (`python -m pytest -q -m cuda tests/test_torch_raycast_kernel.py`),
hold the kernel's colour, depth and segmentation bit for bit to the plain
ops' on the same CUDA inputs, one launch a frame: the Ant camera cell's
full shape and draws, boxes and box-like meshes, a culled scene of more
shapes than a block stages at once, a per-env fov, no ground, grazing rays
and coincident capsule ends, ragged sizes; and its cross product to
torch.linalg.cross's. This file imports no JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from test_isaacgym_tpu_torch import randomize as dr
from test_isaacgym_tpu_torch.core.scene import SHAPE_BOX, SHAPE_CAPSULE, SHAPE_MESH, SHAPE_SPHERE
from test_isaacgym_tpu_torch.ops import _kernels
from test_isaacgym_tpu_torch.render import raster
from test_isaacgym_tpu_torch.render.camera import look_at_quat_t

SKY = (0.32, 0.45, 0.6)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _axis_quat(axis):
    """(..., 4) xyzw quaternions turning +z onto the unit `axis` (..., 3)."""
    z = np.zeros_like(axis)
    z[..., 2] = 1.0
    half = (z + axis) / np.linalg.norm(z + axis, axis=-1, keepdims=True)
    return np.concatenate([np.cross(z, half), (z * half).sum(-1, keepdims=True)], -1)


def scene(n, kinds, seed, device, *, width=32, height=24, ground=True, fov=None, chain=0,
          graze=0):
    """render_camera_batch's keyword arguments for n envs of random shapes of
    `kinds` in front of a camera at a random pose near (-3, 0, 1) looking at
    the origin. `chain` capsules follow `kinds` end to end, each joined to
    the next at a common end sphere; `graze` spheres an env are placed
    tangent to a pixel's ray."""
    rng = np.random.default_rng(seed)
    S = len(kinds)
    eye = np.array([-3.0, 0.0, 1.0]) + rng.uniform(-0.3, 0.3, (n, 3))
    pos = rng.uniform([-1.0, -1.5, -0.3], [1.0, 1.5, 1.5], (n, S, 3))
    quat = _quats(rng, n * S).reshape(n, S, 4)
    size = np.zeros((n, S, 3))
    kinds = np.asarray(kinds)
    size[..., 0] = np.where(kinds == SHAPE_CAPSULE, rng.uniform(0.05, 0.2, (n, S)),
                            rng.uniform(0.1, 0.4, (n, S)))
    size[..., 1] = np.where(kinds == SHAPE_CAPSULE, rng.uniform(0.1, 0.5, (n, S)),
                            rng.uniform(0.05, 0.4, (n, S)))
    size[..., 2] = rng.uniform(0.05, 0.4, (n, S))
    kind = list(kinds)
    if chain:  # capsules of one radius end to end: the Ant's joints
        pts = np.cumsum(rng.uniform(-0.4, 0.4, (n, chain + 1, 3)), 1) + rng.uniform(-0.5, 0.5,
                                                                                  (n, 1, 3))
        seg = pts[:, 1:] - pts[:, :-1]
        length = np.linalg.norm(seg, axis=-1)
        size_c = np.stack([np.full((n, chain), 0.08), length / 2, np.zeros((n, chain))], -1)
        pos = np.concatenate([pos, (pts[:, 1:] + pts[:, :-1]) / 2], 1)
        quat = np.concatenate([quat, _axis_quat(seg / length[..., None])], 1)
        size = np.concatenate([size, size_c], 1)
        kind += [SHAPE_CAPSULE] * chain
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    cam_pos = f32(eye)
    cam_quat = look_at_quat_t(cam_pos, torch.zeros_like(cam_pos))
    hfov = f32(rng.uniform(40.0, 110.0, n)) if fov == "per_env" else 90.0
    if graze:  # spheres whose silhouettes pass through pixel centres
        dirs, _ = raster.camera_rays(width, height, torch.as_tensor(hfov, device=device)
                                     .expand(n), cam_quat)
        pick = rng.choice(width * height, (n, graze))
        d = dirs.cpu().numpy()[np.arange(n)[:, None], pick].astype(np.float64)
        side = np.cross(d, rng.normal(size=(n, graze, 3)))
        side /= np.linalg.norm(side, axis=-1, keepdims=True)
        r = rng.uniform(0.05, 0.3, (n, graze))
        c = eye[:, None] + rng.uniform(2.0, 4.0, (n, graze, 1)) * d + r[..., None] * side
        pos = np.concatenate([pos, c], 1)
        quat = np.concatenate([quat, _quats(rng, n * graze).reshape(n, graze, 4)], 1)
        size = np.concatenate([size, np.stack([r, r, r], -1)], 1)
        kind += [SHAPE_SPHERE] * graze
    S = len(kind)
    light = rng.normal(size=3)
    light[2] = -abs(light[2]) - 0.5
    return dict(
        cam_pos=cam_pos, cam_quat=cam_quat, shape_pos_w=f32(pos), shape_quat_w=f32(quat),
        shape_size=f32(size), kind=torch.as_tensor(kind, dtype=torch.int32, device=device),
        color=f32(rng.uniform(0.05, 1.0, (n, S, 3))),
        seg=torch.arange(1, S + 1, dtype=torch.int32, device=device),
        ground=f32([0.0, 0.0, 1.0, 0.0] if ground else [0.0] * 4),
        light_dir=f32(light / np.linalg.norm(light)), light_color=f32(rng.uniform(0.4, 1.0, 3)),
        ambient=f32(rng.uniform(0.1, 0.5, 3)), bg=f32(SKY), hfov=hfov, width=width,
        height=height, far=1000.0)


MIXED = [SHAPE_SPHERE, SHAPE_BOX, SHAPE_CAPSULE, SHAPE_SPHERE, SHAPE_CAPSULE]


def _refuse_loading(monkeypatch):
    fail = lambda *a, **k: pytest.fail("a library was built or loaded")  # noqa: E731
    monkeypatch.setattr(_kernels, "build", fail)
    monkeypatch.setattr(_kernels, "load", fail)


def test_cpu_frames_never_build_or_load_the_kernel(monkeypatch):
    """A frame of CPU tensors takes the plain ops, builds and loads nothing,
    and leaves the kernels' counts as they were."""
    _refuse_loading(monkeypatch)
    monkeypatch.setattr(raster, "_raycast_cuda", lambda *a, **k: pytest.fail("the wrapper ran"))
    before = dict(_kernels.launches)
    rgba, depth, seg, flow = raster.render_camera_batch(**scene(3, MIXED, 0, "cpu"))
    assert rgba.shape == (3, 24, 32, 4) and flow is None and torch.isfinite(depth).any()
    assert (seg > 0).any()
    assert dict(_kernels.launches) == before


def _wrapper_args(n, S, device, fault=None):
    """_raycast_cuda's arguments for n envs of S shapes, `fault` in one."""
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=device)  # noqa
    args = dict(cam_pos=z(n, 3), cam_quat=z(n, 4), focal=z(n), forward=z(n, 3),
                sp=z(n, S, 3), sq=z(n, S, 4), ssize=z(n, S, 3),
                kind=z(n, S, dtype=torch.int32), color=z(n, S, 3),
                seg=z(n, S, dtype=torch.int32), ground=z(4), light_dir=z(3),
                light_color=z(3), ambient=z(3), sky=z(3))
    if fault == "float64":
        args["sp"] = z(n, S, 3, dtype=torch.float64)
    elif fault == "mis_shaped":
        args["seg"] = z(n, S + 1, dtype=torch.int32)
    elif fault == "float_kind":
        args["kind"] = z(n, S)
    return args


@pytest.mark.parametrize("fault,name,want", [
    ("cpu", "cam_pos", "float32 (2, 3) on one CUDA device (cpu)"),
    ("float64", "shape_pos", "got torch.float64 (2, 3, 3) on cuda:0"),
    ("mis_shaped", "seg", "int32 (2, 3) on one CUDA device"),
    ("float_kind", "kind", "got torch.float32 (2, 3) on cuda:0"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, fault, name, want):
    """CPU tensors, a float64 table, a mis-shaped one and a float kind table
    are refused by name, before any library is loaded or output made."""
    _refuse_loading(monkeypatch)
    if fault == "cpu":
        args = _wrapper_args(2, 3, "cpu")
    else:
        with FakeTensorMode():
            args = _wrapper_args(2, 3, "cuda", fault)
    with pytest.raises(ValueError) as e:
        raster._raycast_cuda(*args.values(), width=8, height=6, far=100.0)
    msg = str(e.value)
    assert msg.startswith(f"raycast kernel: {name} must be ") and want in msg, msg


def _variant(kw, case):
    """The frame `kw` asking for one more pass: render_camera_batch's
    arguments of that case."""
    n, S = kw["shape_pos_w"].shape[:2]
    rng = np.random.default_rng(1)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    if case == "texture":
        kw.update(tex=f32(rng.uniform(0, 1, (1, 8, 8, 3))),
                  tex_id=torch.as_tensor([0] + [-1] * (S - 1), dtype=torch.int32))
    elif case == "hull_rows":
        kw["kind"] = kw["kind"].clone()
        kw["kind"][1] = SHAPE_MESH
        planes = np.zeros((6, 4), np.float32)
        planes[:3, :3], planes[3:, :3], planes[:, 3] = np.eye(3), -np.eye(3), -1.0
        kw.update(mesh_rows=(1,), mesh_planes=planes[None], mesh_base=np.ones((1, 3), np.float32))
    elif case == "triangles":
        kw.update(tri_shape=(1,), tri_v=f32(rng.normal(size=(1, 3, 3)) * 0.2),
                  tri_n=f32(np.tile([0.0, 0.0, 1.0], (1, 3, 1))),
                  tri_base=kw["shape_size"][0].numpy())
    elif case == "soft_triangles":
        kw.update(soft_tris=f32(rng.normal(size=(n, 2, 3, 3)) * 0.3),
                  soft_colors=f32([0.8, 0.4, 0.3]))
    elif case == "lines":
        kw.update(lines=f32(rng.normal(size=(n, 2, 2, 3))), line_colors=f32(np.ones((n, 2, 3))))
    elif case == "flow":
        kw.update(body_lin=f32(np.ones((n, S, 3))), body_ang=f32(np.zeros((n, S, 3))),
                  body_ctr=kw["shape_pos_w"], flow_dt=0.01)
    elif case == "supersampling":
        kw["ss"] = 2
    return kw


@pytest.mark.parametrize("case,kernel", [
    ("primitives", True), ("texture", False), ("hull_rows", False), ("triangles", False),
    ("soft_triangles", False), ("lines", False), ("flow", False), ("supersampling", False),
])
def test_route_is_the_kernel_only_for_the_primitive_pass(monkeypatch, case, kernel):
    """render_camera_batch's choice, as it would make it on a CUDA device:
    the kernel for a frame of spheres, boxes and capsules, the ground and no
    other pass (the Ant camera cell's frame), the plain ops for a frame that
    asks for any other pass. Each frame renders on the CPU."""
    _refuse_loading(monkeypatch)
    routes = []
    on_card = raster._kernel_frame

    def record(dev, *rest):
        routes.append(on_card(torch.device("cuda"), *rest))
        return on_card(dev, *rest)

    monkeypatch.setattr(raster, "_kernel_frame", record)
    kw = _variant(scene(2, MIXED, 4, "cpu", width=16, height=12), case)
    rgba, depth, seg, flow = raster.render_camera_batch(**kw)
    assert routes == [kernel]
    assert rgba.shape == (2, 12, 16, 4) and (flow is not None) == (case == "flow")


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _both(monkeypatch, kw):
    """(the frame through the kernel, the same frame through the plain ops,
    the kernel's launches for the first)."""
    before = _kernels.launches["raycast"]
    got = raster.render_camera_batch(**kw)
    launched = _kernels.launches["raycast"] - before
    with monkeypatch.context() as m:
        m.setattr(raster, "_kernel_frame", lambda *a: False)
        want = raster.render_camera_batch(**kw)
    torch.cuda.synchronize()
    return got, want, launched


def _assert_same(got, want, what):
    for name, x, y in zip(("rgba", "depth", "seg"), got[:3], want[:3]):
        assert x.dtype == y.dtype and x.shape == y.shape and x.is_cuda, (what, name)
        differ = int((x != y).sum())
        assert differ == 0, f"{what}: {differ} of {y.numel()} {name} values differ"
    assert got[3] is None


ARG_NAMES = ("cam_pos", "cam_quat", "shape_pos_w", "shape_quat_w", "shape_size", "kind", "color",
             "seg", "ground", "light_dir", "light_color", "ambient", "bg", "hfov")

# case -> scene's arguments: n, kinds, seed and keywords
KERNEL_CASES = {
    "boxes_and_box_like_meshes": (64, [SHAPE_BOX, SHAPE_MESH, SHAPE_SPHERE] * 4, 11, {}),
    "per_env_fov": (64, MIXED * 2, 12, dict(fov="per_env")),
    "no_ground": (64, MIXED * 2, 13, dict(ground=False)),
    "grazing_rays_and_joined_capsules": (64, MIXED, 14, dict(chain=8, graze=24)),
    "ragged_sizes": (5, MIXED, 15, dict(width=37, height=23)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_equals_plain_bit_for_bit(monkeypatch, case):
    """The kernel's images against the plain ops' on the same CUDA inputs,
    every value equal; one launch a frame."""
    _needs_cuda()
    n, kinds, seed, extra = KERNEL_CASES[case]
    kw = scene(n, kinds, seed, "cuda", **extra)
    got, want, launched = _both(monkeypatch, kw)
    assert launched == 1
    _assert_same(got, want, case)
    hit = torch.isfinite(want[1])
    assert hit.any() and (~hit).any() and (want[2] > 0).any(), case


@pytest.mark.cuda
def test_kernel_equals_plain_on_a_culled_scene(monkeypatch):
    """More shapes than cull_max: the plain ops' gather keeps the nearest
    cull_max (96, more than the kernel stages at once) and the kernel
    renders those, bit for bit."""
    _needs_cuda()
    kw = scene(32, MIXED * 30, 16, "cuda")
    kw["cull_max"] = 96
    got, want, launched = _both(monkeypatch, kw)
    assert launched == 1
    _assert_same(got, want, "culled")


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_ant_camera_cell(monkeypatch):
    """The Ant camera cell's frame at its full shape: 4,096 Ant envs, 64 x 48
    cameras, the benchmark cell's draws (an orbit pose, per-shape colours
    and the light from a generator on the card), 3 seeds x 3 frames, bit for
    bit and one launch a frame."""
    _needs_cuda()
    from test_isaacgym_tpu_torch.core.config import CameraProperties
    from test_isaacgym_tpu_torch.envs import rl_env
    from test_isaacgym_tpu_torch.render.camera import CameraSensor

    n, dev = 4096, "cuda"
    env = rl_env.make(task="Ant", num_envs=n, sim_device=dev, rl_device=dev)
    state, sim = env.state, env.sim
    tables = raster.tables_from_scene(sim.scene, dev)
    seg = torch.full_like(tables.seg, 1)
    cam = CameraSensor(props=CameraProperties(width=64, height=48), num_envs=n, device=dev)
    ground = torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev)
    sky = torch.tensor(SKY, device=dev)
    hfov = torch.full((n,), 90.0, device=dev)
    base = tables.color.expand(n, -1, -1)
    sp, sq = raster.shape_world_poses(state, sim.params, tables, sim.scene)
    frames = 0
    for seed in (0, 2**31 + 5, 987654321):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for _ in range(3):
            eye, target = dr.randomize_camera_pose(gen, n, (0.0, 0.0, 0.4), device=dev)
            colors = dr.randomize_colors(gen, base)
            light_color, ambient, light_dir = dr.randomize_light(gen, dev)
            cam.set_locations(eye, target)
            cp, cq = cam.world_pose(state, sim.env_origins)
            args = (cp, cq, sp, sq, sim.params.shape_size, tables.kind, colors, seg, ground,
                    light_dir, light_color, ambient, sky, hfov)
            kw = dict(width=64, height=48, far=1000.0)
            got, want, launched = _both(monkeypatch, dict(zip(ARG_NAMES, args), **kw))
            assert launched == 1
            _assert_same(got, want, f"seed {seed} frame {frames % 3}")
            assert (want[2] > 0).any() and torch.isfinite(want[1]).any()
            frames += 1
    assert frames == 9


@pytest.mark.cuda
def test_kernel_cross_is_torch_cross():
    """The kernel's cross product, held alone: its bits are
    torch.linalg.cross's on the card for random rows of magnitudes across
    twelve decades, ties and zeros among them."""
    _needs_cuda()
    import ctypes

    rng = np.random.default_rng(21)
    n = 1 << 20
    a, b = (rng.normal(size=(n, 3)) * 10.0 ** rng.uniform(-6, 6, (n, 1)) for _ in range(2))
    a[:1000] = b[:1000]  # a x a = 0
    a[1000:2000, 0] = 0.0
    a, b = (torch.as_tensor(x.astype(np.float32), device="cuda") for x in (a, b))
    out = torch.empty_like(a)
    fn = _kernels.entry("raycast", "raycast_cross", [ctypes.c_void_p] * 3
                        + [ctypes.c_longlong, ctypes.c_void_p])
    _kernels.launch("raycast", fn, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
    want = torch.linalg.cross(a, b, dim=-1)
    torch.cuda.synchronize()
    differ = int((out != want).sum())
    assert differ == 0, f"{differ} of {want.numel()} cross product terms differ"


@pytest.mark.cuda
def test_kernel_refuses_float64_on_the_card():
    """A float64 table on the card raises by name, from the wrapper and from
    render_camera_batch, before anything is launched."""
    _needs_cuda()
    args = _wrapper_args(4, 3, "cuda", "float64")
    before = _kernels.launches["raycast"]
    with pytest.raises(ValueError, match="shape_pos must be float32"):
        raster._raycast_cuda(*args.values(), width=8, height=6, far=100.0)
    kw = scene(4, MIXED, 5, "cuda", width=8, height=6)
    kw["shape_size"] = kw["shape_size"].double()
    with pytest.raises(ValueError, match="shape_size must be float32"):
        raster.render_camera_batch(**kw)
    assert _kernels.launches["raycast"] == before

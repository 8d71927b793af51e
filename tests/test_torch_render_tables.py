"""The renderer's tables on the device (render/raster.py `RenderTables.to`,
`tables_from_scene(scene, device)`): `shape_world_poses` and
`render_camera_batch` give the same bits with the tables as numpy or as
tensors, the frame's constants are made without host copies, and a frame
runs inside the render spans. The port alone, on the CPU."""
import numpy as np
import pytest
import torch

from test_isaacgym_tpu_torch import randomize as dr
from test_isaacgym_tpu_torch.core.config import CameraProperties
from test_isaacgym_tpu_torch.envs import rl_env
from test_isaacgym_tpu_torch.render import raster
from test_isaacgym_tpu_torch.render.camera import CameraSensor, look_at_quat, look_at_quat_t
from test_isaacgym_tpu_torch.utils import trace

N, W, H = 3, 16, 12
GROUND = np.array([0, 0, 1, 0], np.float32)
SKY = np.array([0.32, 0.45, 0.6], np.float32)


@pytest.fixture(scope="module")
def ant():
    env = rl_env.make(task="Ant", num_envs=N, sim_device="cpu", rl_device="cpu")
    # legs at random angles, so that shapes cross and occlude
    g = torch.Generator().manual_seed(5)
    dof = (torch.rand(env.state.dof_pos.shape, generator=g) - 0.5) * 1.2
    env.state = env.sim.stepper.refresh_body_state(env.state._replace(dof_pos=dof),
                                                   env.sim.params)
    return env


def frame(env, tables, seed=3, hfov=90.0):
    """One domain-randomized frame of every env's camera, as the benchmark's
    Ant camera cell renders it."""
    gen = torch.Generator().manual_seed(seed)
    colors = dr.randomize_colors(gen, torch.as_tensor(tables.color).expand(N, -1, -1))
    light, ambient, d = dr.randomize_light(gen, "cpu")
    eye, target = dr.randomize_camera_pose(gen, N, (0.0, 0.0, 0.4), device="cpu")
    cam = CameraSensor(props=CameraProperties(width=W, height=H), num_envs=N, device="cpu")
    cam.set_locations(eye, target)
    cp, cq = cam.world_pose(env.state, env.sim.env_origins)
    sp, sq = raster.shape_world_poses(env.state, env.sim.params, tables, env.sim.scene)
    images = raster.render_camera_batch(
        cp, cq, sp, sq, env.sim.params.shape_size, tables.kind, colors, tables.seg, GROUND, d,
        light, ambient, SKY, hfov, width=W, height=H, far=1000.0)
    return (sp, sq) + images[:3]


def test_tables_to_a_device_keep_their_values_and_dtypes(ant):
    host = raster.tables_from_scene(ant.sim.scene)
    dev = raster.tables_from_scene(ant.sim.scene, "cpu")
    assert type(dev) is raster.RenderTables and host._fields == dev._fields
    for name, a, b in zip(host._fields, host, dev):
        assert torch.is_tensor(b) and b.device.type == "cpu", name
        assert b.dtype == torch.as_tensor(a).dtype and np.array_equal(b.numpy(), a), name
    assert np.array_equal(host.to("cpu").body.numpy(), host.body)


def test_numpy_and_device_tables_render_the_same_bits(ant):
    host = raster.tables_from_scene(ant.sim.scene)
    dev = host.to("cpu")
    a, b = frame(ant, host), frame(ant, dev)
    for name, x, y in zip(("shape_pos", "shape_quat", "rgba", "depth", "seg"), a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    rgba, depth = a[2], a[3]
    assert rgba.shape == (N, H, W, 4) and torch.isfinite(depth).any()
    assert (rgba[..., :3].reshape(N, -1, 3) != torch.as_tensor(SKY * 255).to(torch.uint8)).any()


def test_a_python_fov_and_a_tensor_fov_render_the_same_bits(ant):
    tables = raster.tables_from_scene(ant.sim.scene, "cpu")
    a = frame(ant, tables, hfov=75.0)
    b = frame(ant, tables, hfov=torch.full((N,), 75.0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_the_frames_constants_are_the_bits_of_host_copies():
    """look_at_quat_t's, camera_rays' forward axis and randomize_camera_pose's
    centre are made by fills: the values of the host tensors they replace."""
    g = torch.Generator().manual_seed(11)
    eye = torch.rand((64, 3), generator=g) * 4 - 2
    target = torch.rand((64, 3), generator=g)
    eye[0] = target[0] + torch.tensor([0.0, 0.0, 1.5])  # a view along up
    for up in ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0)):
        q = look_at_quat_t(eye, target, up)
        for i in range(4):
            want = look_at_quat(eye[i].double().numpy(), target[i].double().numpy(), up)
            assert np.allclose(q[i].numpy(), want, atol=1e-6) or np.allclose(
                q[i].numpy(), -want, atol=1e-6), (up, i)
    quat = torch.cat([torch.rand((5, 3), generator=g), torch.ones((5, 1))], -1)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    _, fwd = raster.camera_rays(8, 6, torch.full((5,), 90.0), quat)
    from test_isaacgym_tpu_torch.math.quat import quat_rotate

    want = quat_rotate(quat, torch.tensor([1.0, 0, 0]).expand(5, 3))
    assert torch.equal(fwd, want)
    a = dr.randomize_camera_pose(torch.Generator().manual_seed(2), 7, (0.0, 0.0, 0.4),
                                 device="cpu")
    b = dr.randomize_camera_pose(torch.Generator().manual_seed(2), 7,
                                 torch.tensor([0.0, 0.0, 0.4]), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_frame_runs_inside_the_render_spans_and_the_tables_in_their_stage(ant):
    before = trace.stage_s.get("setup.render", 0.0)
    tables = raster.tables_from_scene(ant.sim.scene, "cpu")
    assert trace.stage_s["setup.render"] > before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        frame(ant, tables)
    spans = {}
    for e in prof.events():
        if e.name.startswith("render"):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert set(spans) == {"render", "render.poses", "render.rays", "render.primitives",
                          "render.pack"}
    (r0, r1), = spans["render"]
    for name in ("render.rays", "render.primitives", "render.pack"):
        assert all(r0 <= a and b <= r1 for a, b in spans[name]), name
    assert all(b <= r0 for a, b in spans["render.poses"])  # the poses come first


@pytest.mark.cuda
def test_a_frame_with_device_tables_makes_no_host_sync():
    """64 Ant envs on the card: with the tables copied there once, a frame
    (the draws, set_locations, world_pose, shape_world_poses and
    render_camera_batch with tensor inputs) runs with host syncs made
    errors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, dev = 64, "cuda"
    env = rl_env.make(task="Ant", num_envs=n, sim_device=dev, rl_device=dev)
    tables = raster.tables_from_scene(env.sim.scene, dev)
    cam = CameraSensor(props=CameraProperties(width=64, height=48), num_envs=n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    ground, sky = torch.tensor(GROUND, device=dev), torch.tensor(SKY, device=dev)
    hfov = torch.full((n,), 90.0, device=dev)

    def frame():
        eye, target = dr.randomize_camera_pose(gen, n, (0.0, 0.0, 0.4), device=dev)
        colors = dr.randomize_colors(gen, tables.color.expand(n, -1, -1))
        light, ambient, d = dr.randomize_light(gen, dev)
        cam.set_locations(eye, target)
        cp, cq = cam.world_pose(env.state, env.sim.env_origins)
        sp, sq = raster.shape_world_poses(env.state, env.sim.params, tables, env.sim.scene)
        return raster.render_camera_batch(
            cp, cq, sp, sq, env.sim.params.shape_size, tables.kind, colors, tables.seg, ground,
            d, light, ambient, sky, hfov, width=64, height=48, far=1000.0)

    frame()  # warm: the allocator and library handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rgba = frame()[0]
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rgba.shape == (n, 48, 64, 4) and rgba.device.type == "cuda"

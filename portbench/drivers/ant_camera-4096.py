"""Driver of the configuration ant_camera-4096: Isaac Gym's
examples/domain_randomization.py camera over the Ant scene of
`rl_env.make(task="Ant")` at 4,096 envs, held at its reset pose (traffic
"frames"). A step is one frame of every env's 64 x 48 camera: the
program's side renders the frame's draws through the path of
`Gym.render_all_camera_sensors` (`CameraSensor.set_locations`,
`world_pose`, `raster.shape_world_poses`, `raster.render_camera_batch`,
the scene's tables copied to the card once in set-up), then draws the next
frame's camera pose, colours and light with the port's randomizers from a
torch.Generator on the card seeded from the run's seed.
reference/ant_camera.py renders the same draws over the same body poses
on the reference's and the control's side."""
from typing import NamedTuple

import numpy as np
import torch

from portbench.harness import sides
from portbench.harness.cell import Cell
from portbench.harness.spec import ROOT
from portbench.reference import ant_camera as ref


class Frame(NamedTuple):
    """A frame's draws, on the card."""
    eye: torch.Tensor  # (N, 3) env-local
    target: torch.Tensor  # (N, 3)
    colors: torch.Tensor  # (N, S, 3)
    light_color: torch.Tensor  # (3,)
    ambient: torch.Tensor  # (3,)
    light_dir: torch.Tensor  # (3,)


def inputs(cfg, traffic, seed, device, rank=0):
    """The pose the scene is held at (its DOF angles: the reset pose's
    zeros) and the seed of the draws, made of (seed, rank)."""
    state = np.random.SeedSequence([seed % 2**63, rank]).generate_state(2, np.uint32)
    return {"dof_pos": np.zeros((cfg["num_envs"], cfg["widths"]["dofs_per_env"]), np.float32),
            "seed": int(state[0]) << 32 | int(state[1])}


def _program(cfg, traffic, inputs, device) -> Cell:
    rl_env, raster, dr = (sides.port(m) for m in ("envs.rl_env", "render.raster", "randomize"))
    CameraSensor = sides.port("render.camera").CameraSensor
    CameraProperties = sides.port("core.config").CameraProperties
    n, c, rz = cfg["num_envs"], cfg["camera"], cfg["randomize"]
    env = rl_env.make(task="Ant", num_envs=n, sim_device=device, rl_device=device)
    sim = env.sim
    dof = torch.as_tensor(inputs["dof_pos"], device=device)
    state = sim.stepper.refresh_body_state(sim.initial_state._replace(dof_pos=dof), sim.params)
    params, scene, origins = sim.params, sim.scene, sim.env_origins
    tables = raster.tables_from_scene(scene, device)
    tables = tables._replace(seg=torch.full_like(tables.seg, cfg["segmentation_id"]))
    cam = CameraSensor(props=CameraProperties(width=c["width"], height=c["height"],
                                              horizontal_fov=c["horizontal_fov"],
                                              far_plane=c["far_plane"]),
                       num_envs=n, device=device)
    g = cfg["ground"]
    ground = torch.tensor(list(g["normal"]) + [g["distance"]], device=device)
    sky = torch.tensor(cfg["sky"], device=device)
    hfov = torch.full((n,), cam.props.horizontal_fov, device=device)
    base = tables.color.expand(n, -1, -1)
    gen = torch.Generator(device=device).manual_seed(inputs["seed"])

    def draw():
        eye, target = dr.randomize_camera_pose(gen, n, tuple(rz["orbit_center"]),
                                               tuple(rz["orbit_radius"]),
                                               tuple(rz["orbit_height"]), device=device)
        colors = dr.randomize_colors(gen, base)
        light_color, ambient, light_dir = dr.randomize_light(gen, device)
        return Frame(eye, target, colors, light_color, ambient, light_dir)

    def step(fr):
        cam.set_locations(fr.eye, fr.target)
        cp, cq = cam.world_pose(state, origins)
        sp, sq = raster.shape_world_poses(state, params, tables, scene)
        rgba, depth, seg, _ = raster.render_camera_batch(
            cp, cq, sp, sq, params.shape_size, tables.kind, fr.colors, tables.seg, ground,
            fr.light_dir, fr.light_color, fr.ambient, sky, hfov, width=cam.props.width,
            height=cam.props.height, far=float(cam.props.far_plane))
        return draw(), (rgba, depth, seg)

    sp, sq = raster.shape_world_poses(state, params, tables, scene)
    start = ref.shape_fields(sp - origins[:, None], sq, params.shape_size[..., :2])
    kinds = tables.kind.tolist()  # set-up: the work's shape, read once
    work = {"render.work": {"envs": n, "width": c["width"], "height": c["height"],
                            "spheres": kinds.count(raster.SHAPE_SPHERE),
                            "capsules": kinds.count(raster.SHAPE_CAPSULE),
                            "ground": int(scene.ground is not None)}}
    return Cell(
        envs=n, starts=[draw()], step=step,
        fields=lambda s, out: start if out is None else ref.compared(out),
        counts=lambda s: work,
        handoff=lambda fr: ref.State(state.body_pos, state.body_quat, *fr),
    )


def _reference(cfg, traffic, inputs, device) -> Cell:
    cams = ref.AntCameras(cfg, ROOT, inputs["dof_pos"], device, inputs["seed"])
    return Cell(envs=cfg["num_envs"], starts=[cams.start()], step=cams.step,
                fields=cams.fields)


def build(cfg, traffic, inputs, device, impl="program", rank=0, world=1):
    if impl == "program":
        return _program(cfg, traffic, inputs, device)
    return sides.reference_cell(_reference(cfg, traffic, inputs, device), impl)


def reference(cfg, traffic, inputs, device, rank=0, world=1):
    return _reference(cfg, traffic, inputs, device)

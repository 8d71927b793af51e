#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card (random worlds, the
piled 1080-ball state, and a dense 1080-sphere cube whose contact lists
spill out of shared memory), shows that two solves of the same inputs give
the same bits, drives the 1080-ball sphere world (envs/balls.py, 36
pyramids) through its entry points with the kernels' launch counts read
around that run alone, profiles 20 of its steps, runs the 120-ball drop
against tests/goldens/balls_drop.npz, then drives the flagship Franka OSC
path (envs/franka.py, 4096 envs of the mesh-free Panda stand-in, plain
PyTorch ops and no hand-written kernel: its counts are read around its own
run and must stay 0), profiles 10 of its steps, checks an 8-env run against
the stand-in golden, then drives the franka_cube pick path (envs/franka_cube.py,
4096 envs of the stand-in with collision boxes on the hand and fingers, OSC,
the contact table's narrowphase and two-way Jacobi solve: plain PyTorch, its
sphere-world count must stay 0), runs one of its steps with host syncs made
errors, times its layers, profiles 10 of its steps, checks a 4-env run of
each controller against franka_cube_standin.npz, reports its grip and lift
shares beside the JAX env's; then the paths with no kernel of their own,
each with its counts read around its run: 4096 attractor-driven Pandas
(examples/franka_attractor.py's moving target), the 4096-env UAV-car
pursuit (and 16 envs against tests/goldens/uav_car.npz), 1080 boxes on the
neighbor-list solve (sphere-world count 0), and 100 spheres beside 100
boxes, where the sphere-world kernel runs beside that solve (its launches
counted exactly, the kernel held against its plain version on that world);
then the TIG_DEBUG checks (a planted NaN raises, verify_step_purity on the
balls, Franka OSC and franka_cube steps); last the convex-hull and terrain
paths, each with its counts read around its run: kuka_bin.py's five objects
(a cube, two convex hulls made by create_mesh_asset, a sphere, a capsule)
in each of 4096 envs on a ground plane (hull_pile4096) and over the 1200 x
2000 AnymalTerrain heightfield (terrain4096), no kernel (sphere-world count
0), each held to an 8-env golden made by the JAX package; and the 1080 balls
over a terrain bowl (balls_terrain1080), where the sphere-world kernel runs
without its ground beside 1080 sphere-terrain rows of the contact table
(launches counted exactly, the kernel held against its plain version on
that world's piled inputs); then the SDF paths, each with its counts read
around its run (the sphere-world count must stay 0): bench.py's nut_bolt
config, 1024 envs of a nut spun down the procedural bolt for 240 steps
(envs/nut_bolt.py, the code-built nut stand-in's probes against the bolt's
closed form; every env's descent held to test_nut_threads_down's bar,
a 2-env run to nut_bolt_standin.npz, a TIG_DEBUG step), and the reference
example's 512 envs of the arm-driven screw FSM from the nut threaded on the
bolt (envs/franka_nut_bolt.py: both SDF families, the trilinear lookup of
the nut's voxel grid at full width; its FSM shares and mean nut descent
held to the JAX env's at 512 envs, both starts at 2 envs to
franka_nut_bolt_standin.npz); last the soft-body path, with its counts read
around its run (the sphere-world count must stay 0): the reference's
examples/soft_body.py at 1024 envs for 120 steps (envs/soft_body.py, the
code-built tet icosphere stand-in on the XPBD solve, a press plate held
over it), every env's lowest vertex and volume ratio against the example's
and tests/test_soft.py's bounds and their spread against the JAX package's
1024 envs, two 10-step runs bitwise equal, a TIG_DEBUG step, and 4 envs
and the pedestal scene (sphere, capsule and hull colliders) against
soft_body_standin.npz and soft_pedestals_standin.npz; last the RL
vec-env surface and the renderer (envs/rl_env.py, render/raster.py,
render/camera.py), each with its counts read around its run (the
sphere-world count must stay 0): make(task="Ant") at 4096 envs on the
code-written Ant stand-in for 200 steps of RandomState(0) actions (a step
with host syncs made errors; the envs still in the scene finite and in
their joint limits; the share of envs that reset, the share thrown out of
the scene and the others' mean torso height against the JAX package's
4096 envs; 4 envs to ant_standin.npz's horizon; render() of env 0 against
the JAX frame), make(task="Franka") at 4096 envs for 60 steps (8 envs to
franka_reach_standin.npz), bench.py's render config at 1600 x 900 on one
env of the FrankaNutBoltEnv scene (its triangle and hull passes; 160 x 90
against render_standin.npz), and a 64 x 48 CameraSensor on each of the
4096 Ant envs for 10 domain-randomized frames, two runs bitwise equal; last
the gymapi facade (gymapi/facade.py, envs/gym_scenes.py) driven as the
reference's scripts drive it, each path with its counts read around its
run and a step (simulate, refresh_*, set_*) with host syncs made errors:
1080_balls_of_solitude.py --all_collisions as gym calls (one create_env, a
create_actor a ball), 400 steps of simulate + refresh_actor_root_state_tensor
through the sphere-world kernel (exactly 800 launches), balls1080's bounds
read from the wrapped tensors, whose storage the refreshes keep, the KEY_R
snapshot reset bit for bit, and 120 balls against gym_balls_standin.npz;
examples/franka_osc.py's build and loop at 4096 envs on the Panda stand-in
(the rigid-body, DOF, Jacobian and mass-matrix tensors wrapped, the OSC on
the card, 300 steps), its mean tracking error under the example's 0.12 m
and within 10% of the JAX facade's, the native FrankaOscEnv's ms/step
beside it, and 8 envs against gym_franka_osc_standin.npz; and
examples/interop_torch.py's scene at 1024 envs (a ball and a 128 x 128
camera with enable_tensors in each), 30 frames of simulate, render and the
image tensor on the card (its data_address its data_ptr), two runs bitwise
equal, env 0's frame against gym_interop_standin.npz; last env-axis
sharding (parallel/mesh.py) at world size 1 over NCCL, joined in this
process on a free localhost port: bench.py's _bench_sharded config, the
full Franka OSC step at 1024 envs through rollout_with_obs for 20 steps,
its gathered dof_pos against the native FrankaOscEnv rollout and the
gather's share of a step, and 4 worlds of 1080 balls for 40 steps through
the sphere-world kernel (launches counted exactly) held to the unsharded
run, the contact force summed by psum_metrics. It
prints:
  * the card's name and power limit (nvidia-smi);
  * per-phase numbers (build seconds, kernel and plain times, each launch's
    share of a solve and one sweep's cost, ball-steps/s, Franka env-steps/s
    and ms/step, device busy share, device launches per step and the
    kernels that take the most device time). A kernel's time is its
    device time per call, replayed from a CUDA graph; the same calls made
    back to back from Python are also shown, host overhead included;
  * one JSON line {"kernels": [...]} with each kernel's launches on the
    main path, error against its plain version, times and bound;
  * last, {"ok": true, "device": {...}}.
Any failed phase raises, and the script exits non-zero without the last
line. It needs a CUDA device and imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM data sheet (dense, 700 W): f32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations of one sphere-world solve, per unit of work its data needs
# (sqrt and division count as one): the distance test of every candidate
# pair, once; the per-pair setup of each active pair (normal, material mix,
# effective masses, pre-solve normal velocity, target), once; the update of
# each active pair in each sweep (relative velocity, normal and friction
# impulses, both bodies' sums); each sphere's split update and ground
# contact in each sweep.
OPS_CANDIDATE, OPS_PAIR_SETUP, OPS_PAIR_SWEEP, OPS_BODY_SWEEP = 12, 60, 100, 80

SOLVE_TOL = 1e-5  # kernel vs plain, of the largest magnitude
STEPS = 400  # end-to-end 1080-ball run
PILE_STEPS = 120  # steps before capturing the piled F=1080 solve inputs
PROFILE_STEPS = 20  # main-path steps under torch.profiler
# the goldens' rule on the card: the 120-ball drop vs tests/goldens/balls_drop.npz
# and the Franka stand-in vs its franka_osc_standin.npz
GOLDEN_TOL = 1e-4
FRANKA_ENVS = 4096  # the flagship's width (bench.py, BASELINE.json)
FRANKA_STEPS = 200  # timed Franka run
FRANKA_PROFILE_STEPS = 10
FRANKA_GOLDEN_ENVS, FRANKA_GOLDEN_EVERY = 8, 10  # franka_osc_standin.npz: steps 0, 10, ..., 50
# Median distance of the hand from its circle target after FRANKA_STEPS
# steps. The JAX env gives 0.045785 m on the CPU (every env tracks the same
# circle from the same pose; printed by tests/test_torch_franka.py run as a
# script); the card holds the golden to 1e-4, so 0.05 m leaves room for
# rounding and fails a controller or a step that has gone wrong.
FRANKA_TRACK_BOUND = 0.05
# the franka_cube pick path (bench.py's second config: 4096 envs, OSC)
CUBE_ENVS, CUBE_STEPS, CUBE_PROFILE_STEPS = 4096, 100, 10
# franka_cube_standin.npz: 4 envs of each controller, steps 0, 10, ..., 60
CUBE_GOLDEN_ENVS, CUBE_GOLDEN_EVERY = 4, 10
# The JAX env on the stand-in, OSC, CUBE_STEPS steps of the same CUBE_ENVS
# envs of seed 42 (tests/test_torch_franka_cube.py's docstring and its
# script): grip and lift shares, and the lowest cube bottom at the end.
JAX_GRIP_SHARE, JAX_LIFT_SHARE = 1.0, 0.997803
# A few envs press a dropped cube into the table with the open hand; the
# JAX env's lowest cube ends 2.3 cm into the 0.4 m table top.
JAX_CUBE_BOTTOM = 0.376557
# A contact-rich grasp is chaotic: after 100 steps single envs part from
# the JAX env's (the goldens bound the physics), so the shares may fall
# short by CUBE_SHARE_SLACK and the lowest cube may lie CUBE_SINK_SLACK m
# deeper than the JAX env's.
CUBE_SHARE_SLACK, CUBE_SINK_SLACK = 0.01, 0.005
# the attractor path: examples/franka_attractor.py on the stand-in (fixed
# base, gravity off), at the flagship's width. The example averages the
# hand's distance from its moving target over the steps after
# ATTRACTOR_SETTLE and bounds the mean by ATTRACTOR_BOUND m.
ATTRACTOR_ENVS, ATTRACTOR_STEPS, ATTRACTOR_SETTLE = 4096, 240, 120
ATTRACTOR_BOUND = 0.03
ATTRACTOR_START = np.array([0.0, 0.0, 0.0, -1.2, 0.0, 1.5, 0.0, 0.02, 0.02], np.float32)
# the UAV-car pursuit path; uav_car.npz holds 16 envs at steps 0, 15, ..., 300.
# Bounds of tests/test_vecenv.py: each car within UAV_CIRCLE_SLACK m of its
# 10 m loiter circle, its pixel within UAV_PIXEL_BOUND px of the image centre.
UAV_ENVS, UAV_STEPS = 4096, 600
UAV_GOLDEN_ENVS, UAV_GOLDEN_EVERY = 16, 15
UAV_CIRCLE_SLACK, UAV_PIXEL_BOUND = 0.5, 2.0
# the neighbor-list path: tests/test_neighbor_world.py's 1080-box world
# (120 steps; its bounds: every box on the ground, z in (0.05, 0.3), |v| <
# 0.1) and its mixed world of 100 spheres and 100 boxes (80 steps; z in
# (0.05, 0.6)), whose spheres take the sphere-world kernel
BOX_COUNT, BOX_STEPS, MIXED_STEPS = 1080, 120, 80
# the convex-hull and terrain paths (envs/pile.py): kuka_bin.py's five
# objects in every env of HULL_ENVS on a ground plane, and of TERRAIN_ENVS
# over the AnymalTerrain map, each PILE_STEPS steps; their 8-env goldens
# (hull_pile.npz, terrain_pile.npz, made by the JAX package) hold root
# poses every 10th step. After PILE_STEPS steps hull_pile's lowest object
# clearance may lie HULL_SINK_SLACK m under the JAX package's on the same
# 4096 envs, and its share of envs at rest (every object slower than
# REST_SPEED) may differ from the JAX package's by HULL_REST_SLACK; both
# JAX values are stored in hull_pile.npz (tests/test_torch_hull.py run as a
# script). On terrain every object ends above its local terrain height -
# TERRAIN_BELOW, below it + TERRAIN_ABOVE and inside the map
# (tests/test_gymapi.py::test_terrain_heightfield_contact's bounds), where
# the local terrain is the lowest, and the highest, within TERRAIN_REACH m
# of the object's centre (the objects' half extents are up to 0.09 m).
HULL_ENVS = TERRAIN_ENVS = 4096
PILE_STEPS, PILE_GOLDEN_EVERY = 120, 10
HULL_SINK_SLACK, HULL_REST_SLACK, REST_SPEED = 0.005, 0.01, 0.1
TERRAIN_BELOW, TERRAIN_ABOVE, TERRAIN_REACH = 0.05, 0.45, 0.1
# the 1080 balls over a 64 x 64 pyramid_sloped_terrain(slope=-0.5) bowl at
# 0.25 m x 0.005 m (terrain_creation.py's terrain), offset under the
# pyramids: the sphere-world kernel without its ground, 240 steps; no ball
# centre more than BALL_SINK m under the terrain (test_gymapi.py's bound)
BALLS_TERRAIN_STEPS, BALL_SINK = 240, 0.05
# the SDF paths: bench.py's nut_bolt@1024 (240 steps at dt 1/120: two turns
# at 1 rev/s), every env's descent within NUT_RTOL of 2 pitches with the
# envs agreeing within NUT_SPREAD m (tests/test_nut_bolt.py::
# test_nut_threads_down); and the reference example's franka_nut_bolt at 512
# envs from the bolt start, FNB_STEPS steps (in the JAX env every env is in
# S_SCREW from ~step 90 to ~205), each FSM state's share within
# FNB_SHARE_SLACK of the JAX env's and the mean nut descent within
# FNB_DESCENT_RTOL of its (both stored in franka_nut_bolt_standin.npz)
NUT_ENVS, NUT_STEPS, NUT_RTOL, NUT_SPREAD = 1024, 240, 0.20, 5e-4
FNB_ENVS, FNB_STEPS, FNB_SHARE_SLACK, FNB_DESCENT_RTOL = 512, 150, 0.02, 0.20
# the soft-body path: examples/soft_body.py's scene (envs/soft_body.py, the
# code-built icosphere stand-in) at SOFT_ENVS envs, SOFT_STEPS steps (2 s:
# the drop, the impact and the settle). Every env's lowest vertex in
# SOFT_LOWEST (the example's bound), and its volume ratio in SOFT_VOLUME
# (tests/test_soft.py's bound, written for Young's 1e5) where its Young's
# modulus is at least SOFT_BOUND_YOUNGS: the example draws it down to 2e4,
# where a 1 m ball of density 1000 squashes past 0.75 or its tets collapse
# in both packages (the JAX package's 1024 envs: 3 envs under 0.75, all
# below 3.4e4). Over those envs the min, mean and max of the volume ratio
# and the min and mean of the lowest vertex (its max is whichever ball is
# mid-bounce at the last step) within SOFT_SLACK_FACTOR times the JAX
# package's own jitted-vs-op-by-op difference after SOFT_STEPS steps (4
# envs; both stored in soft_body_standin.npz with the JAX package's
# 1024-env numbers, which are jitted): its jitted and op-by-op runs part
# after 4 steps, so the card is held to the distributions, as
# franka_cube's shares are, an order of magnitude wide: the card follows
# the op-by-op arithmetic, and over 1024 envs its mean volume ratio sits
# ~2.6e-3 under the jitted run's
SOFT_ENVS, SOFT_STEPS, SOFT_REPEAT_STEPS = 1024, 120, 10
# a soft step is ~26,000 launches, and the profiler's cost grows with them;
# every step launches the same kernels, so 3 steps give a step's breakdown
SOFT_PROFILE_STEPS = 3
SOFT_LOWEST, SOFT_VOLUME, SOFT_BOUND_YOUNGS, SOFT_SLACK_FACTOR = (-0.05, 0.35), (0.75, 1.1), 5e4, 10.0
# the RL vec-envs (envs/rl_env.py): make(task="Ant") at IsaacGymEnvs' Ant
# numEnvs, ANT_STEPS steps of actions uniform in [-1, 1] from
# RandomState(0). Its share of envs that reset, share that left the scene
# (thrown past LEFT_HEIGHT or not finite: the JAX env's 30 N m on the Ant's
# light links throws ~7% of them) and the others' mean torso height after the
# last step within ANT_SLACK_FACTOR times the JAX package's own
# jitted-vs-op-by-op difference of the same statistic at the same width
# (ant_standin.npz, tools/make_rl_goldens.py); the 4-env golden to its
# horizon (28 steps: the JAX package's own jitted and op-by-op runs differ
# by half the tolerance at step 29 and part at 33; an H100, a third
# rounding path, parted at step 29 on the reward, by 1.081e-4, 1.6x their
# difference there); render() of env 0 there against the JAX frame,
# per-shape segmentation and colour within one count on all but
# FRAME_SHARE of it.
ANT_ENVS, ANT_STEPS, ANT_PROFILE_STEPS, ANT_SLACK_FACTOR = 4096, 200, 3, 10.0
LEFT_HEIGHT, FRAME_SHARE = 10.0, 0.01
# make(task="Franka"): FrankaReachVecEnv, REACH_STEPS steps; its 8-env golden
REACH_ENVS, REACH_STEPS = 4096, 60
# bench.py's render config (bench.py:122-176) on one env of the
# FrankaNutBoltEnv scene (the arm's boxes, the nut stand-in's visual mesh by
# the triangle pass and its hull), RENDER_FRAMES frames; 160 x 90 of the
# same camera against render_standin.npz
RENDER_SIZE, RENDER_SMALL, RENDER_FRAMES = (1600, 900), (160, 90), 8
RENDER_EYE, RENDER_TARGET = (1.6, 0.9, 0.9), (0.0, 0.0, 0.4)
# a 64 x 48 CameraSensor on each of the ANT_ENVS Ant envs
# (examples/domain_randomization.py:27's camera), CAMERA_FRAMES frames each
# after randomize_colors, randomize_light and randomize_camera_pose
CAMERA_SIZE, CAMERA_FRAMES = (64, 48), 10
# the gymapi facade (gymapi/facade.py) driven as the reference's scripts
# drive it (envs/gym_scenes.py): the 1080 balls through gym calls, GYM_BALL_STEPS
# of simulate + refresh_actor_root_state_tensor, balls1080's bounds, and the
# 120-ball run against gym_balls_standin.npz; examples/franka_osc.py's loop at
# GYM_OSC_ENVS envs, GYM_OSC_STEPS steps (the example's), its mean tracking
# error after step 150 under the example's GYM_OSC_BOUND m and within
# GYM_OSC_RTOL of the JAX facade's (gym_franka_osc_standin.npz: every env
# tracks the same circle from the same pose, so the JAX facade's 8 envs give
# the mean at any width), 8 envs against that golden, and the native
# FrankaOscEnv's ms/step beside it (NATIVE_STEPS steps where this call has not
# timed franka4096); examples/interop_torch.py's scene at GYM_CAMERA_ENVS
# envs, GYM_CAMERA_FRAMES frames of simulate, render and the image tensor, two
# runs bitwise equal, env 0's frame against gym_interop_standin.npz
GYM_BALL_STEPS = 400
GYM_OSC_ENVS, GYM_OSC_STEPS, GYM_OSC_BOUND, GYM_OSC_RTOL = 4096, 300, 0.12, 0.10
NATIVE_STEPS = 50
GYM_CAMERA_ENVS, GYM_CAMERA_FRAMES = 1024, 30
# env-axis sharding over torch.distributed (parallel/mesh.py), one rank a
# card: bench.py's _bench_sharded config, the full Franka OSC step through
# rollout_with_obs with obs dof_pos, SHARD_ENVS envs a rank for SHARD_STEPS
# steps, the gathered obs against the native FrankaOscEnv rollout of all the
# envs within GOLDEN_TOL * max(|ref|, 1); BallsEnv with SHARD_WORLDS worlds of
# 1080 balls a rank, SHARD_BALL_STEPS steps through the sphere-world kernel
# (exactly 2 launches a solve), the positions within SOLVE_TOL of the largest
# magnitude of the unsharded run, the contact force summed over ranks by
# psum_metrics. Here in one process at world size 1 over NCCL;
# tools/chip_phases.py's `sharded` runs a rank a card.
SHARD_ENVS, SHARD_STEPS, SHARD_WORLDS, SHARD_BALL_STEPS = 1024, 20, 4, 40
SHARD_TIMEOUT = 300  # seconds a collective waits for a peer
# the device of every phase's envs ("cpu" only in a rehearsal of the phases on the CPU)
DEV = "cuda"
# sphere-world launches and ms/step of each main path's timed run, by path
PATH_LAUNCHES = {}
STEP_MS = {}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_rel_err(want, got):
    """(max |err|, max |err| / max(|want|, 1)) over a list of tensor pairs."""
    abs_err, rel = 0.0, 0.0
    for w, g in zip(want, got):
        e = float((w - g).abs().max())
        abs_err = max(abs_err, e)
        rel = max(rel, e / max(float(w.abs().max()), 1.0))
    return abs_err, rel


def random_solve_args(seed, N, F, device):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, (N, F, 3)).astype(np.float32)
    pos[..., 2] = rng.uniform(0.1, 1.0, (N, F))
    vel = rng.uniform(-1, 1, (N, F, 3)).astype(np.float32)
    omega = rng.uniform(-3, 3, (N, F, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.25, (N, F)).astype(np.float32)
    m = (4 / 3 * np.pi * r**3 * 500.0).astype(np.float32)
    inv_i = (1.0 / (0.4 * m * r * r)).astype(np.float32)
    mu = rng.uniform(0.3, 1.0, (N, F)).astype(np.float32)
    rest = rng.uniform(0.0, 0.8, (N, F)).astype(np.float32)
    arrays = (pos, vel, omega, r, (1.0 / m).astype(np.float32), inv_i, mu, rest)
    return [torch.as_tensor(a, device=device) for a in arrays]


def dense_cube(F=1080):
    """The dense world, as numpy (pos, vel, omega, radius, inv_m, inv_i, mu,
    rest) of one world: F spheres of r = 0.2 uniform in a 1.6 m cube
    (RandomState(7)). At F = 1080 it has 30,410 live pairs, up to 96 a
    sphere: about 30x the pile, more than shared memory holds. The `cuda`
    tests of tests/test_torch_sphere_world.py use it too."""
    rng = np.random.RandomState(7)
    pos = rng.uniform(0.0, 1.6, (1, F, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (1, F, 3)).astype(np.float32)
    omega = rng.uniform(-3, 3, (1, F, 3)).astype(np.float32)
    r = np.full((1, F), 0.2, np.float32)
    m = (4 / 3 * np.pi * r**3 * 500.0).astype(np.float32)
    mu = rng.uniform(0.3, 1.0, (1, F)).astype(np.float32)
    rest = rng.uniform(0.0, 0.8, (1, F)).astype(np.float32)
    return (pos, vel, omega, r, (1.0 / m).astype(np.float32),
            (1.0 / (0.4 * m * r * r)).astype(np.float32), mu, rest)


def random_spec(sw, F, device):
    spec = sw.SphereWorldSpec(
        shape_idx=np.arange(F, dtype=np.int32), free_idx=np.arange(F, dtype=np.int32),
        body_slot=np.arange(F, dtype=np.int32), allow=np.triu(np.ones((F, F), bool), 1),
        has_ground=True, plane_n=np.array([0, 0, 1], np.float32), plane_d=0.0,
        plane_friction=1.0, plane_restitution=0.0,
    )
    return spec.to(device)


def time_ms(fn, reps, warmup=3):
    """Mean ms of fn() on the card, CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps):
    """Mean device ms of fn() replayed from a CUDA graph: the host's launch
    overhead, larger than the device time of a short kernel on a shared
    host, stays out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: allocations and one-time attributes outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return time_ms(g.replay, reps)


def sphere_world_bound(args):
    """(bound_ms, bound_by, active pairs) of one solve on these inputs."""
    spec, pos, vel, omega, radius = args[:5]
    iters, contact_offset = args[10], args[11]
    N, F, _ = pos.shape
    allow = torch.as_tensor(spec.allow, device=pos.device)
    dist = torch.linalg.vector_norm(pos[:, :, None] - pos[:, None], dim=-1)
    depth = radius[:, :, None] + radius[:, None, :] - dist
    active = int((allow[None] & (depth > -contact_offset)).sum())
    candidates = N * int(spec.allow.sum())
    ops = (candidates * OPS_CANDIDATE + active * (OPS_PAIR_SETUP + iters * OPS_PAIR_SWEEP)
           + N * F * iters * OPS_BODY_SWEEP)
    n_in = sum(a.numel() for a in args[1:9])  # f32 inputs
    # + the allow mask's upper triangle (the lower half is zero by
    # construction) as one bit a pair, as the kernel reads it packed + 3 f32
    # outputs
    nbytes = 4 * n_in + -(-(F * (F - 1) // 2) // 8) + 4 * 3 * (3 * N * F)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    log(f"sphere_world bound: {ops} operations ({t_ops:.6f} ms), {nbytes} bytes ({t_bytes:.6f} ms)")
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), active


def check_solve(sw, args, tag):
    """Kernel vs plain on the same inputs; returns the max |err|."""
    got = sw.solve(*args)
    want = sw._torch_solve(*args)
    torch.cuda.synchronize()
    for t in got:
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{tag}: kernel output is not finite")
    abs_err, rel = max_rel_err(want, got)
    log(f"kernel vs plain {tag}: max |err| {abs_err:.3e}, of largest magnitude {rel:.3e}")
    if rel > SOLVE_TOL:
        raise RuntimeError(f"{tag}: kernel disagrees with plain: {rel:.3e} > {SOLVE_TOL}")
    return abs_err


def check_repeatable(sw, args, tag):
    """Two solves of the same inputs must give the same bits."""
    a, b = sw.solve(*args), sw.solve(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError(f"{tag}: two solves of the same inputs differ")
    log(f"bitwise repeatable {tag}: yes")


def launch_shares(solve, reps=20):
    """Device time per solve of each of the kernel's launches
    (torch.profiler over `reps` solves)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            solve()
        torch.cuda.synchronize()
    times = {e.key: e.self_device_time_total / reps for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and ("sw_broadphase" in e.key or "sw_sweeps" in e.key)}
    total = sum(times.values())
    if not total:
        log("launch shares: device time not measured (no device events)")
        return
    for key, us in sorted(times.items(), key=lambda kv: -kv[1]):
        name = "sw_broadphase" if "sw_broadphase" in key else "sw_sweeps"
        log(f"  launch {name}: {us:.2f} us/solve, {100 * us / total:.1f}% of the solve")


def profile_steps(run_steps, state, step_ms, steps=PROFILE_STEPS, unit="step"):
    """Where a step's time goes: torch.profiler over `steps` steps of a
    path (`run_steps` runs that many). Prints device busy time per step
    (device-side events only: kernels, copies, sets), its share of the
    unprofiled step time `step_ms`, device launches per step and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_steps(state)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps(state)
        torch.cuda.synchronize()
    dev = sorted(
        ((e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda d: -d[2],
    )
    if not dev:
        log(f"profile {steps} {unit}s: device time not measured (no device events)")
        return
    busy_us = sum(d[2] for d in dev) / steps
    log(f"profile {steps} {unit}s: device busy {busy_us:.1f} us/{unit}, "
        f"{100 * busy_us / (step_ms * 1e3):.1f}% of the {step_ms:.4f} ms {unit}; "
        f"{sum(d[1] for d in dev) / steps:.1f} device launches/{unit}")
    for key, count, us in dev[:6]:
        log(f"  {us / steps:8.1f} us/{unit} {count / steps:5.1f}x/{unit}  {key[:90]}")
    sw = [d for d in dev if "sw_broadphase" in d[0] or "sw_sweeps" in d[0]]
    log(f"  sphere_world kernels: {sum(d[2] for d in sw) / steps:.1f} us/{unit}, "
        f"{sum(d[1] for d in sw) / steps:.1f} launches/{unit}")


def count_ops(fn) -> int:
    """PyTorch operators that fn() dispatches, views left out: in eager mode
    each is about one device launch made by the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.is_view
            return func(*args, **(kwargs or {}))

    with Count() as counter:
        fn()
    return counter.n


def franka_layers(env, state) -> None:
    """Ops and host ms (time_layers) of the layers of one Franka step: the
    control, phase A with the body cache reused (first substep) and with FK
    (second substep), and the refresh. Phase D is the rest."""
    st, params, actions = env.sim.stepper, env.sim.params, env.sim.actions
    layers = {
        "control (jacobian, mass matrix, 7x7 and 6x6 solves)":
            lambda: env._control(state, state.steps, params=params),
        "phase A, body cache reused (dynamics, 9x9 solve)":
            lambda: st.group_velocities(state, actions, params, True),
        "phase A with FK": lambda: st.group_velocities(state, actions, params, False),
        "refresh (FK)": lambda: st.refresh_body_state(state, params),
    }
    time_layers(layers)


def time_layers(layers) -> None:
    """Print each layer's ops (count_ops) and host ms: the clock around 5
    calls after a warm one, ending in a synchronize, over 5."""
    for name, fn in layers.items():
        ops = count_ops(fn)
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        log(f"  layer {name}: {ops} ops, {(time.perf_counter() - t) / 5 * 1e3:.3f} ms")


def franka_phase(kernels) -> None:
    """The flagship Franka OSC path at FRANKA_ENVS envs: a timed run with
    the hand-written kernels' counts read around it (the path has none, so
    every count must stay 0), checks of its end state, a profile, and an
    8-env run against the stand-in golden."""
    from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT, FrankaOscEnv

    t = time.perf_counter()
    env = FrankaOscEnv(num_envs=FRANKA_ENVS, device=DEV)
    log(f"franka: {FRANKA_ENVS} envs built in {time.perf_counter() - t:.2f} s")
    env.rollout_fn(2)(env.sim.state)  # warm: allocator and library handles
    one = env.rollout_fn(1)
    log(f"franka: {count_ops(lambda: one(env.sim.state))} non-view PyTorch ops a step")
    run = env.rollout_fn(FRANKA_STEPS)
    s, step_ms, launches = timed(lambda: run(env.sim.state), kernels, "franka", FRANKA_STEPS,
                                 FRANKA_ENVS, "env")
    if any(launches.values()):
        raise RuntimeError(f"the Franka path launched hand-written kernels: {launches}")
    assert_finite(s, "franka")
    assert_in_limits(s, env.sim.params, "franka")
    env.sim.state = s
    track = float(np.median(env.tracking_error(FRANKA_STEPS)))
    log(f"franka median tracking error after {FRANKA_STEPS} steps: {track:.6f} m "
        f"(bound {FRANKA_TRACK_BOUND})")
    if not track < FRANKA_TRACK_BOUND:
        raise RuntimeError(f"franka tracking error {track:.6f} m >= {FRANKA_TRACK_BOUND}")

    profile_steps(env.rollout_fn(FRANKA_PROFILE_STEPS), s, step_ms, FRANKA_PROFILE_STEPS)
    franka_layers(env, s)

    golden = np.load(os.path.join(STANDIN_ROOT, "franka_osc_standin.npz"))
    small = FrankaOscEnv(num_envs=FRANKA_GOLDEN_ENVS, device=DEV)
    worst = golden_err({k: golden[k] for k in ("hand_pos", "dof_pos")}, small.sim.state,
                       lambda s: {"hand_pos": s.body_pos[:, small.hand_body],
                                  "dof_pos": s.dof_pos},
                       small.rollout_fn(FRANKA_GOLDEN_EVERY))
    log(f"franka {FRANKA_GOLDEN_ENVS} envs vs stand-in golden (hand_pos, dof_pos every "
        f"{FRANKA_GOLDEN_EVERY} steps): max |err| of largest magnitude {worst:.3e}")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"franka departs from the stand-in golden: {worst:.3e} > {GOLDEN_TOL}")


def cube_layers(env, ps) -> None:
    """Ops and host ms (time_layers) of the layers of a step of an arm
    env with free objects (franka_cube, franka_nut_bolt): the control, and
    of a substep phase A (body cache reused, then with FK), phase B, phase
    C's inputs (current poses, link Jacobians, A^-1), narrowphase, the
    solve's set-up (narrowphase included), one Jacobi sweep (a substep runs
    `iters` of them, then a few ops of read-back and contact force), phase
    D; and the refresh."""
    stp, params = env.sim.stepper, env.sim.params
    state = ps.sim
    actions = env.control(ps)[0]
    gd = stp.group_velocities(state, actions, params, True)
    fd = stp.free_velocities(state, actions, params)
    cur_bp, cur_bq, jac, a_inv = stp.contact_inputs(state, gd, fd)
    c = stp.contact
    solve_args = (cur_bp, cur_bq, (state.body_linvel, state.body_angvel), fd["v"], fd["w"],
                  fd["m"], fd["I_w"], fd["com_w"], [g["qd_full"] for g in gd], jac, a_inv,
                  params, stp.h)
    s = c.prepare(*solve_args)
    layers = {
        "control (FSM, jacobian, solves)": lambda: env.control(ps),
        "phase A, body cache reused": lambda: stp.group_velocities(state, actions, params, True),
        "phase A with FK": lambda: stp.group_velocities(state, actions, params, False),
        "phase B (free bodies)": lambda: stp.free_velocities(state, actions, params),
        "phase C inputs (poses, link jacobians, A^-1)": lambda: stp.contact_inputs(state, gd, fd),
        "narrowphase": lambda: c.narrowphase(cur_bp, cur_bq, params),
        "solve set-up (narrowphase included)": lambda: c.prepare(*solve_args),
        f"one Jacobi sweep (x{s.iters} a substep)": s.sweep,
        "phase D": lambda: stp.integrate(state, gd, fd, params),
        "refresh (FK)": lambda: stp.refresh_body_state(state, params),
    }
    time_layers(layers)


def assert_finite(state, what) -> None:
    for name, v in state._asdict().items():
        if v is not None and v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"{what} state.{name} is not finite")


def assert_in_limits(state, params, what) -> None:
    lim = params.dof_has_limits
    if ((lim & (state.dof_pos < params.dof_lower)) | (lim & (state.dof_pos > params.dof_upper))).any():
        raise RuntimeError(f"{what} dof_pos left its joint limits")


def rel_err(got, want) -> float:
    """max |got - want| / max(|want|, 1) of a tensor against a numpy array."""
    return float(np.abs(got.cpu().numpy() - want).max()) / max(float(np.abs(want).max()), 1.0)


def golden_err(golden, state, snap, advance) -> float:
    """Max |err| / max(|want|, 1) of snap(state) (a dict of tensors) against
    golden[key][k] for each of the golden's snapshots k, with
    state = advance(state) between snapshots."""
    worst, count = 0.0, len(next(iter(golden.values())))
    for k in range(count):
        for key, value in snap(state).items():
            want = golden[key][k]
            err = float(np.abs(value.cpu().numpy() - want).max())
            worst = max(worst, err / max(float(np.abs(want).max()), 1.0))
        if k + 1 < count:
            state = advance(state)
    return worst


def assert_sync_free(fn, what) -> None:
    """fn() (one step) with host syncs made errors."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"{what}: one step ran with host syncs made errors: none")


def timed(run, kernels, what, steps, width, unit):
    """run() (a loop of `steps` steps of `width` of `unit`, "env" or "body")
    under the host clock, ending in a synchronize, with the hand-written
    kernels' counts read around it. Returns (its result, ms/step, launches)."""
    torch.cuda.synchronize()
    kernels.launches.clear()
    t = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.launches)
    PATH_LAUNCHES[what] = launches.get("sphere_world", 0)
    STEP_MS[what] = wall / steps * 1e3
    log(f"{what} main path: {steps} steps of {width} {unit} in {wall:.3f} s: "
        f"{width * steps / wall:.1f} {unit}-steps/s, {wall / steps * 1e3:.4f} ms/step, "
        f"sphere_world launches {launches.get('sphere_world', 0)}")
    return out, wall / steps * 1e3, launches


def device_ms(fn, reps=5):
    """Device busy ms per call of fn() (torch.profiler, device-side events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3 if us else None


def attractor_sim(num_envs):
    """(sim, env body of the hand) of examples/franka_attractor.py on the
    stand-in: each env's Panda at the example's start pose, an attractor
    on its hand (stiffness 5e5, damping 5e3, all axes)."""
    from test_isaacgym_tpu_torch.assets import load_urdf
    from test_isaacgym_tpu_torch.core.config import SimParams
    from test_isaacgym_tpu_torch.core.scene import SceneBuilder
    from test_isaacgym_tpu_torch.core.sim import Simulator
    from test_isaacgym_tpu_torch.envs.franka import FRANKA_URDF, STANDIN_ROOT

    asset = load_urdf(STANDIN_ROOT, FRANKA_URDF, fix_base_link=True)
    asset.disable_gravity = True
    hand = asset.rigid_body_dict()["panda_hand"]
    b = SceneBuilder(SimParams(dt=1 / 60, substeps=2))
    n_row = max(int(np.sqrt(num_envs)), 1)
    for e in range(num_envs):
        b.create_env((-1, -1, 0), (1, 1, 2), n_row)
        slot = b.create_actor(e, asset, name="franka", group=e, filter=1)
        b.add_attractor(e, slot, hand, stiffness=5e5, damping=5e3)
    sim = Simulator(*b.finalize(DEV), device=DEV)
    sim.dof_state = np.stack([np.tile(ATTRACTOR_START, num_envs),
                              np.zeros(9 * num_envs, np.float32)], -1)
    return sim, sim.scene.find_actor("franka").body_start + hand


def attractor_phase(kernels) -> None:
    """The attractor path at ATTRACTOR_ENVS envs: the hand follows the
    example's moving target (written into the actions every step from the
    step count, on the device) for ATTRACTOR_STEPS steps."""
    from test_isaacgym_tpu_torch.physics import dynamics

    t = time.perf_counter()
    sim, hand = attractor_sim(ATTRACTOR_ENVS)
    log(f"attractor: {ATTRACTOR_ENVS} envs built in {time.perf_counter() - t:.2f} s")
    stp, params, actions0 = sim.stepper, sim.params, sim.actions
    dt = sim.scene.sim_params.dt
    base_pos = sim.state.body_pos[:, hand]
    base_quat = sim.state.body_quat[:, hand, None]

    def step(state):
        """One step toward the example's target at sim time steps * dt:
        (state, target (N, 3))."""
        tt = state.steps.to(torch.float32) * dt
        off = torch.stack([torch.zeros_like(tt), 0.1 * torch.sin(1.5 * tt),
                           0.1 * torch.cos(1.5 * tt) - 0.1])
        target = base_pos + off
        actions = actions0._replace(attractor_target_pos=target[:, None],
                                    attractor_target_quat=base_quat)
        return stp.step(state, actions, params), target

    def run(state, steps):
        err = torch.zeros(ATTRACTOR_ENVS, device=base_pos.device)
        for k in range(steps):
            state, target = step(state)
            if k > ATTRACTOR_SETTLE:
                err = err + torch.linalg.vector_norm(state.body_pos[:, hand] - target, dim=-1)
        return state, err / max(steps - ATTRACTOR_SETTLE - 1, 1)

    s0 = sim.state
    step(s0)  # warm
    log(f"attractor: {count_ops(lambda: step(s0))} non-view PyTorch ops a step")
    assert_sync_free(lambda: step(s0), "attractor")
    (s, err), step_ms, launches = timed(lambda: run(s0, ATTRACTOR_STEPS), kernels, "attractor",
                                        ATTRACTOR_STEPS, ATTRACTOR_ENVS, "env")
    if any(launches.values()):
        raise RuntimeError(f"the attractor path launched hand-written kernels: {launches}")
    assert_finite(s, "attractor")
    assert_in_limits(s, params, "attractor")
    worst = float(err.max())
    log(f"attractor mean hand-to-target error over steps {ATTRACTOR_SETTLE + 1}-"
        f"{ATTRACTOR_STEPS - 1}: worst env {worst:.6f} m, mean {float(err.mean()):.6f} m "
        f"(bound {ATTRACTOR_BOUND})")
    if not worst < ATTRACTOR_BOUND:
        raise RuntimeError(f"an attractor env's mean error {worst:.6f} m >= {ATTRACTOR_BOUND}")

    def run10(state):
        for _ in range(10):
            state = step(state)[0]
        return state

    profile_steps(run10, s, step_ms, 10)
    gi, att = stp.groups[0], stp.attractors_by_group[0][0]
    pos, quat, _, _ = stp._link_state_from_bodies(gi, s)
    M = dynamics.mass_matrix(gi.topo, pos, quat, mass=stp._link_params(gi, params.body_mass, 0.0),
                             com=stp._link_params(gi, params.body_com, 0.0),
                             inertia=stp._link_params(gi, params.body_inertia, 0.0))
    qd = s.dof_vel[:, gi.dof_idx]
    time_layers({
        "phase A, body cache reused (attractor included)":
            lambda: stp.group_velocities(s, actions0, params, True),
        "the attractor impulse (one attractor, one substep)":
            lambda: stp._attractor_impulse(att, gi.topo, pos, quat, M, qd, actions0, params),
    })


def uav_phase(kernels) -> None:
    """The UAV-car pursuit path at UAV_ENVS envs for UAV_STEPS steps, and
    a 16-env run against tests/goldens/uav_car.npz."""
    from test_isaacgym_tpu_torch.envs.uav_car import UavCarEnv

    t = time.perf_counter()
    env = UavCarEnv(num_envs=UAV_ENVS, device=DEV)
    log(f"uav_car: {UAV_ENVS} envs built in {time.perf_counter() - t:.2f} s")
    s0 = env.init_state
    env.rollout(2)  # warm
    log(f"uav_car: {count_ops(lambda: env.step_fn(s0))} non-view PyTorch ops a step")
    assert_sync_free(lambda: env.step_fn(s0), "uav_car")
    (final, (pixels, _)), step_ms, launches = timed(
        lambda: env.rollout(UAV_STEPS), kernels, "uav_car", UAV_STEPS, UAV_ENVS, "env")
    if any(launches.values()):
        raise RuntimeError(f"the uav_car path launched hand-written kernels: {launches}")
    assert_finite(final.sim, "uav_car")
    if not torch.isfinite(final.cam_rot).all():
        raise RuntimeError("uav_car cam_rot is not finite")
    car = final.sim.root_pos[:, env.car_slot]
    r = torch.linalg.vector_norm(car[:, :2] - env.target_w[:, :2], dim=1)
    off_circle = float((r - env.car_radius).abs().max())
    centre = torch.tensor([env.cam_width / 2, env.cam_height / 2], device=car.device)
    pix_err = float(torch.linalg.vector_norm(env.car_pixel(final) - centre, dim=1).max())
    log(f"uav_car after {UAV_STEPS} steps: cars at most {off_circle:.6f} m off their "
        f"{env.car_radius} m circles (bound {UAV_CIRCLE_SLACK}), car pixels at most "
        f"{pix_err:.6f} px from the centre (bound {UAV_PIXEL_BOUND})")
    if not (off_circle < UAV_CIRCLE_SLACK and pix_err < UAV_PIXEL_BOUND):
        raise RuntimeError("uav_car: a car left its circle or the image centre")
    profile_steps(lambda st: env.rollout(10, st)[0], final, step_ms, 10)

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "goldens", "uav_car.npz"))
    small = UavCarEnv(num_envs=UAV_GOLDEN_ENVS, device=DEV)
    worst = golden_err({k: golden[k] for k in ("uav_pos", "car_pos", "uav_quat")},
                       small.init_state,
                       lambda st: {"uav_pos": st.sim.root_pos[:, small.uav_slot],
                                   "car_pos": st.sim.root_pos[:, small.car_slot],
                                   "uav_quat": st.sim.root_quat[:, small.uav_slot]},
                       lambda st: small.rollout(UAV_GOLDEN_EVERY, st)[0])
    log(f"uav_car {UAV_GOLDEN_ENVS} envs vs uav_car.npz (uav_pos, car_pos, uav_quat every "
        f"{UAV_GOLDEN_EVERY} steps): max |err| of largest magnitude {worst:.3e}")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"uav_car departs from its golden: {worst:.3e} > {GOLDEN_TOL}")


def box_sim(n_boxes, spheres=False):
    """tests/test_neighbor_world.py's worlds: n_boxes boxes of half extent
    0.1 m in one collision group on a ground (jittered grid, seed 3, dt
    1/60, 2 substeps, 4 position iterations), or with spheres=True its mixed
    world of 100 spheres (r = 0.1 m) and 100 boxes (seed 0)."""
    from test_isaacgym_tpu_torch.assets.primitives import create_box, create_sphere
    from test_isaacgym_tpu_torch.core.config import PlaneParams, SimParams
    from test_isaacgym_tpu_torch.core.scene import SceneBuilder
    from test_isaacgym_tpu_torch.core.sim import Simulator

    sp = SimParams(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, -9.8))
    box = create_box(0.2, 0.2, 0.2, density=500.0)
    b = SceneBuilder(sp)
    b.add_ground(PlaneParams())
    b.create_env((-50, -50, 0), (50, 50, 10), 1)
    if spheres:
        ball = create_sphere(0.1, density=500.0)
        rng = np.random.RandomState(0)
        for i in range(200):
            gx, gy = divmod(i, 15)
            b.create_actor(0, box if i % 2 else ball,
                           pos=(gx * 0.35, gy * 0.35, 0.12 + rng.uniform(0, 0.3)),
                           name=f"o{i}", group=-1, filter=0)
    else:
        sp.physx.num_position_iterations = 4
        rng = np.random.RandomState(3)
        side = int(np.ceil(np.sqrt(n_boxes)))
        for i in range(n_boxes):
            gy, gx = divmod(i, side)
            jitter = rng.uniform(-0.01, 0.01, 2)
            b.create_actor(0, box, pos=(gx * 0.25 + jitter[0], gy * 0.25 + jitter[1], 0.102),
                           name=f"box{i}", group=-1, filter=0)
    return Simulator(*b.finalize(DEV), device=DEV)


def neighbor_solve_args(sim, state):
    """The arguments of the neighbor-world solve of the first substep of a
    step from `state`, caught as the step makes them."""
    from test_isaacgym_tpu_torch.ops import neighbor_world as nw

    caught, solve = [], nw.solve

    def catch(*args, **kw):
        caught.append((args, kw))
        return solve(*args, **kw)

    nw.solve = catch
    try:
        sim.stepper.step(state, sim.actions, sim.params)
    finally:
        nw.solve = solve
    return caught[0]


def box_phase(kernels) -> None:
    """The 1080-box world on the neighbor-list path: BOX_STEPS steps, twice
    from the same state (they must give the same bits), a profile and the
    solve's device time."""
    from test_isaacgym_tpu_torch.ops import neighbor_world as nw

    sim = box_sim(BOX_COUNT)
    stp = sim.stepper
    c = stp.contact
    if c.neighbor_world is None or c.sphere_world is not None or c.num_contacts:
        raise RuntimeError("the box world does not take the neighbor-list path alone")
    spec = c.neighbor_world
    log(f"box{BOX_COUNT}: {len(spec.shape_idx)} boxes, K = {spec.k_neighbors}, "
        f"{len(spec.shape_idx) * spec.k_neighbors * nw.MANIFOLD + 8 * len(spec.shape_idx)} "
        f"contact rows a solve, {stp.substeps} solves a step")

    def run(state, steps):
        return stp.rollout(state, sim.actions, sim.params, steps)

    s0 = sim.state
    run(s0, 1)  # warm
    log(f"box{BOX_COUNT}: {count_ops(lambda: run(s0, 1))} non-view PyTorch ops a step")
    assert_sync_free(lambda: run(s0, 1), f"box{BOX_COUNT}")
    s, step_ms, launches = timed(lambda: run(s0, BOX_STEPS), kernels, f"box{BOX_COUNT}",
                                 BOX_STEPS, BOX_COUNT, "body")
    if launches.get("sphere_world", 0):
        raise RuntimeError(f"the box world launched the sphere-world kernel: {launches}")
    assert_finite(s, f"box{BOX_COUNT}")
    z = s.root_pos[0, :, 2]
    vmax = float(s.root_linvel.abs().max())
    log(f"box{BOX_COUNT} after {BOX_STEPS} steps: z in [{float(z.min()):.4f}, "
        f"{float(z.max()):.4f}], max |v| {vmax:.6f}")
    if not (float(z.min()) > 0.05 and float(z.max()) < 0.3 and vmax < 0.1):
        raise RuntimeError(f"the {BOX_COUNT}-box world did not settle on the ground")
    again = run(s0, BOX_STEPS)
    diff = max(float((a - b).abs().max()) for a, b in zip(s, again)
               if a is not None and a.is_floating_point() and a.numel())
    log(f"box{BOX_COUNT}: two runs of {BOX_STEPS} steps from one state: max |difference| "
        f"{diff:.3e} (the solve's per-body sums are segment sums, no atomics)")
    if diff != 0.0:
        raise RuntimeError(f"two box{BOX_COUNT} runs from one state differ by {diff:.3e}")
    profile_steps(lambda st: run(st, 10), s, step_ms, 10)
    args, kw = neighbor_solve_args(sim, s)
    dev_ms = device_ms(lambda: nw.solve(*args, **kw))
    log(f"box{BOX_COUNT} neighbor-world solve: {count_ops(lambda: nw.solve(*args, **kw))} ops, "
        f"device {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}, "
        f"host clock {time_ms(lambda: nw.solve(*args, **kw), reps=5, warmup=1):.4f} ms a solve")


def mixed_phase(kernels, sw) -> float:
    """The mixed world of 100 spheres and 100 boxes: the sphere-world
    kernel beside the neighbor-list solve, MIXED_STEPS steps with the
    kernel's launches counted, and the kernel held against its plain
    version on this world's inputs. Returns that max |err|."""
    sim = box_sim(0, spheres=True)
    stp = sim.stepper
    c = stp.contact
    if c.neighbor_world is None or c.sphere_world is None or c.neighbor_world.ground_spheres:
        raise RuntimeError("the mixed world does not take both dense paths")
    if c.num_contacts:
        raise RuntimeError(f"the mixed world left {c.num_contacts} rows in the static table")
    log(f"mixed200: {len(c.sphere_world.shape_idx)} spheres on the sphere-world path, "
        f"{len(c.neighbor_world.shape_idx)} bodies on the neighbor-list path, static table empty")

    def run(state, steps):
        return stp.rollout(state, sim.actions, sim.params, steps)

    s0 = sim.state
    run(s0, 1)  # warm
    log(f"mixed200: {count_ops(lambda: run(s0, 1))} non-view PyTorch ops a step")
    assert_sync_free(lambda: run(s0, 1), "mixed200")
    want = sw.LAUNCHES_PER_SOLVE * stp.substeps * MIXED_STEPS
    s, step_ms, launches = timed(lambda: run(s0, MIXED_STEPS), kernels, "mixed200",
                                 MIXED_STEPS, 200, "body")
    log(f"mixed200: sphere_world launches {launches.get('sphere_world', 0)}, want "
        f"{sw.LAUNCHES_PER_SOLVE} a solve x {stp.substeps} solves a step x {MIXED_STEPS} "
        f"steps = {want}")
    if launches.get("sphere_world", 0) != want:
        raise RuntimeError(f"the mixed world launched the kernel {launches} times, want {want}")
    assert_finite(s, "mixed200")
    z = s.root_pos[0, :, 2]
    log(f"mixed200 after {MIXED_STEPS} steps: z in [{float(z.min()):.4f}, {float(z.max()):.4f}]")
    if not (float(z.min()) > 0.05 and float(z.max()) < 0.6):
        raise RuntimeError("the mixed world sank or blew up")
    profile_steps(lambda st: run(st, 10), s, step_ms, 10)
    fd = stp.free_velocities(s, sim.actions, sim.params)
    args = c._sphere_world_inputs(s.body_pos, fd["v"], fd["w"], fd["m"], fd["I_w"],
                                  sim.params, stp.h)
    return check_solve(sw, args, f"mixed200 F={args[1].shape[1]} after {MIXED_STEPS} steps")


def debug_phase() -> None:
    """TIG_DEBUG=1 for this phase only: a NaN planted in one env's root
    velocity makes a step raise FloatingPointError; a Franka OSC step under
    the flag passes; verify_step_purity passes on the balls, Franka OSC and
    franka_cube steps."""
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv
    from test_isaacgym_tpu_torch.envs.franka import FrankaOscEnv
    from test_isaacgym_tpu_torch.envs.franka_cube import FrankaCubeEnv
    from test_isaacgym_tpu_torch.utils import debug

    os.environ["TIG_DEBUG"] = "1"
    try:
        balls = BallsEnv(pyramids=4, device=DEV).sim
        vel = balls.state.root_linvel.clone()
        vel[0, 7, 2] = float("nan")
        try:
            balls.stepper.step(balls.state._replace(root_linvel=vel), balls.actions, balls.params)
        except FloatingPointError as e:
            log(f"debug: a NaN in one root velocity raised FloatingPointError: {e}")
        else:
            raise RuntimeError("TIG_DEBUG=1 let a NaN in the state through a step")
        debug.verify_step_purity(balls.stepper, balls.state, balls.actions, balls.params)
        franka = FrankaOscEnv(num_envs=8, device=DEV)
        assert_finite(franka.rollout_fn(1)(franka.sim.state), "debug franka")
        debug.verify_step_purity(franka.sim.stepper, franka.sim.state, franka.sim.actions,
                                 franka.sim.params)
        cube = FrankaCubeEnv(num_envs=4, device=DEV)
        debug.verify_step_purity(cube.sim.stepper, cube.sim.state,
                                 cube.control(cube.init_state)[0], cube.sim.params)
    finally:
        del os.environ["TIG_DEBUG"]
    log("debug: a Franka OSC step under TIG_DEBUG=1 passed; verify_step_purity passed on "
        "the balls, Franka OSC and franka_cube steps")


def pile_layers(sim, state) -> None:
    """Ops and host ms (time_layers) of the contact table's layers in a
    step of a free-body world: the narrowphase (hull and heightfield kinds
    included), the solve's set-up (narrowphase included) and one Jacobi
    sweep."""
    stp, params = sim.stepper, sim.params
    fd = stp.free_velocities(state, sim.actions, params)
    cur_bp, cur_bq, jac, a_inv = stp.contact_inputs(state, [], fd)
    c = stp.contact
    solve_args = (cur_bp, cur_bq, (state.body_linvel, state.body_angvel), fd["v"], fd["w"],
                  fd["m"], fd["I_w"], fd["com_w"], [], jac, a_inv, params, stp.h)
    s = c.prepare(*solve_args)
    time_layers({
        "narrowphase": lambda: c.narrowphase(cur_bp, cur_bq, params),
        "solve set-up (narrowphase included)": lambda: c.prepare(*solve_args),
        f"one Jacobi sweep (x{s.iters} a substep)": s.sweep,
    })


def port_data(name) -> str:
    """The path of a file the port commits under its assets/data/."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_isaacgym_tpu_torch",
                        "assets", "data", name)


def pile_sim(env_ids, terrain=None):
    """A Simulator of envs `env_ids` of envs/pile.py's grid on DEV."""
    from test_isaacgym_tpu_torch.assets import primitives
    from test_isaacgym_tpu_torch.core import config
    from test_isaacgym_tpu_torch.core.scene import SceneBuilder
    from test_isaacgym_tpu_torch.core.sim import Simulator
    from test_isaacgym_tpu_torch.envs import pile

    b = SceneBuilder(pile.pile_params(config))
    pile.build(b, config, pile.pile_assets(primitives), env_ids, terrain=terrain)
    return Simulator(*b.finalize(DEV), device=DEV)


def pile_phase(kernels, name, terrain=None) -> None:
    """The hull_pile path (terrain None) or the terrain path at 4096 envs:
    a step with host syncs made errors, PILE_STEPS timed steps with the
    kernels' counts read around them (the sphere-world count must stay 0),
    the path's bounds, a profile, the contact layers' ops and host ms, and
    8 envs against the path's golden."""
    from test_isaacgym_tpu_torch.envs import pile

    width = TERRAIN_ENVS if terrain is not None else HULL_ENVS
    t = time.perf_counter()
    sim = pile_sim(range(width), terrain)
    stp, c = sim.stepper, sim.stepper.contact
    kinds = dict(zip(*np.unique(c.job.kind, return_counts=True)))
    log(f"{name}: {width} envs built in {time.perf_counter() - t:.2f} s, {c.num_contacts} "
        f"contact rows an env (rows of each kind: {({int(k): int(v) for k, v in kinds.items()})})")
    if not set(range(10, 17)) <= set(kinds) or c.sphere_world is not None:
        raise RuntimeError(f"{name} does not hold every hull kind on the table alone")

    def run(state, steps):
        return stp.rollout(state, sim.actions, sim.params, steps)

    s0 = sim.state
    run(s0, 1)  # warm
    log(f"{name}: {count_ops(lambda: run(s0, 1))} non-view PyTorch ops a step")
    assert_sync_free(lambda: run(s0, 1), name)
    s, step_ms, launches = timed(lambda: run(s0, PILE_STEPS), kernels, name, PILE_STEPS, width,
                                 "env")
    if launches.get("sphere_world", 0):
        raise RuntimeError(f"{name} launched the sphere-world kernel: {launches}")
    assert_finite(s, name)
    depth = c.narrowphase(s.body_pos, s.body_quat, sim.params)[2].cpu().numpy()
    clearance = pile.ground_clearance(c, depth)
    speed = torch.linalg.vector_norm(s.root_linvel, dim=-1)
    rest = float((speed < REST_SPEED).all(1).float().mean())
    log(f"{name} after {PILE_STEPS} steps: lowest clearance {clearance.min():.6f} m (env "
        f"{clearance.argmin()}), share of envs at rest {rest:.6f}")
    golden = np.load(port_data(f"{'terrain' if terrain is not None else 'hull'}_pile.npz"))
    if terrain is None:
        low, share = float(golden["jax_lowest"]), float(golden["jax_rest_share"])
        log(f"  JAX package, the same {width} envs on the CPU: lowest clearance {low:.6f} m, "
            f"share at rest {share:.6f}")
        if clearance.min() < low - HULL_SINK_SLACK or abs(rest - share) > HULL_REST_SLACK:
            raise RuntimeError(f"{name} sinks deeper or rests otherwise than the JAX package")
    else:
        check_terrain_bounds(sim, s, name, golden)
    profile_steps(lambda st: run(st, 10), s, step_ms, 10)
    pile_layers(sim, s)

    ids = [int(k) for k in golden["env_ids"]]
    small = pile_sim(ids, terrain)
    every = PILE_GOLDEN_EVERY
    worst = golden_err({k: golden[k] for k in ("root_pos", "root_quat")}, small.state,
                       lambda st: {"root_pos": st.root_pos, "root_quat": st.root_quat},
                       lambda st: small.stepper.rollout(st, small.actions, small.params, every))
    log(f"{name} {len(ids)} envs vs its golden (root_pos, root_quat every {every} steps to step "
        f"{every * (len(golden['root_pos']) - 1)}): max |err| of largest magnitude {worst:.3e}")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"{name} departs from its golden: {worst:.3e} > {GOLDEN_TOL}")


def centre_heights(sim, state):
    """(height of each object's centre above the terrain there, whether it
    is over the map), flattened over envs: the terrain at a centre is the
    heightfield's nearest cell, as tests/test_gymapi.py reads it."""
    hf = sim.scene.heightfield
    pos = state.root_pos.reshape(-1, 3).cpu().numpy()
    R, C = hf.data.shape
    i = np.rint((pos[:, 0] - hf.offset_x) / hf.horizontal_scale).astype(int)
    j = np.rint((pos[:, 1] - hf.offset_y) / hf.horizontal_scale).astype(int)
    inside = (i >= 0) & (i < R) & (j >= 0) & (j < C)
    return pos[:, 2] - hf.data[np.clip(i, 0, R - 1), np.clip(j, 0, C - 1)], inside


def check_terrain_bounds(sim, state, name, golden) -> None:
    """Every object inside the map, its centre above the lowest terrain
    within TERRAIN_REACH m of it - TERRAIN_BELOW and below the highest
    there + TERRAIN_ABOVE (pile.terrain_clearance)."""
    from test_isaacgym_tpu_torch.envs import pile

    hf = sim.scene.heightfield
    _, inside = centre_heights(sim, state)
    below, above = pile.terrain_clearance(hf.data, hf.horizontal_scale, hf.offset_x,
                                          state.root_pos.cpu().numpy(), TERRAIN_REACH)
    log(f"{name}: lowest centre {below:.6f} m above the lowest terrain within "
        f"{TERRAIN_REACH} m (bound -{TERRAIN_BELOW}; JAX package on the CPU "
        f"{float(golden['jax_below']):.6f}), highest {above:.6f} m above the highest (bound "
        f"{TERRAIN_ABOVE}; JAX {float(golden['jax_above']):.6f}), "
        f"{int((~inside).sum())} outside the map")
    if not (inside.all() and below > -TERRAIN_BELOW and above < TERRAIN_ABOVE):
        raise RuntimeError(f"{name}: an object left the map or its terrain bounds")


def balls_terrain_phase(kernels, sw) -> float:
    """The 1080 balls over a bowl: the sphere-world kernel's no-ground branch
    held against its plain version on the piled inputs, BALLS_TERRAIN_STEPS
    steps with its launches counted exactly, the sinking bound, a profile.
    Returns the kernel's max |err| there."""
    from test_isaacgym_tpu_torch import terrain_utils as tu
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv

    sub = tu.SubTerrain(width=64, length=64, vertical_scale=0.005, horizontal_scale=0.25)
    bowl = tu.pyramid_sloped_terrain(sub, slope=-0.5).height_field_raw
    env = BallsEnv(pyramids=36, device=DEV, heightfield=(bowl, 0.25, 0.005, -8.0, -8.0))
    sim = env.sim
    stp, c = sim.stepper, sim.stepper.contact
    if c.sphere_world is None or c.sphere_world.has_ground or c.num_contacts != env.balls_per_world:
        raise RuntimeError("the balls over terrain do not take the no-ground kernel beside the table")
    log(f"balls_terrain1080: {env.balls_per_world} balls over a 64 x 64 bowl, the kernel without "
        f"ground, {c.num_contacts} sphere-terrain rows in the table")
    s0 = sim.state
    run = env.rollout_fn(BALLS_TERRAIN_STEPS)
    env.rollout_fn(1)(s0)  # warm
    log(f"balls_terrain1080: {count_ops(lambda: env.rollout_fn(1)(s0))} non-view PyTorch ops a step")
    assert_sync_free(lambda: env.rollout_fn(1)(s0), "balls_terrain1080")
    want = sw.LAUNCHES_PER_SOLVE * stp.substeps * BALLS_TERRAIN_STEPS
    s, step_ms, launches = timed(lambda: run(s0), kernels, "balls_terrain1080",
                                 BALLS_TERRAIN_STEPS, env.balls_per_world, "ball")
    log(f"balls_terrain1080: sphere_world launches {launches.get('sphere_world', 0)}, want "
        f"{sw.LAUNCHES_PER_SOLVE} a solve x {stp.substeps} a step x {BALLS_TERRAIN_STEPS} = {want}")
    if launches.get("sphere_world", 0) != want:
        raise RuntimeError(f"balls_terrain1080 launched the kernel {launches} times, want {want}")
    assert_finite(s, "balls_terrain1080")
    depth = float(c.narrowphase(s.body_pos, s.body_quat, sim.params)[2].max())
    above, inside = centre_heights(sim, s)
    jax = np.load(port_data("terrain_pile.npz"))
    log(f"balls_terrain1080 after {BALLS_TERRAIN_STEPS} steps: lowest ball centre "
        f"{above.min():.6f} m above the terrain (bound -{BALL_SINK}; JAX package on the CPU "
        f"{float(jax['jax_balls_lowest']):.6f}), {int((~inside).sum())} off the bowl; deepest "
        f"contact {depth:.6f} m (JAX {float(jax['jax_balls_depth']):.6f})")
    if not (above.min() > -BALL_SINK and inside.all()):
        raise RuntimeError(f"a ball sank under the terrain or left it: {above.min():.6f} m")
    profile_steps(env.rollout_fn(10), s, step_ms, 10)
    pile_layers(sim, s)
    fd = stp.free_velocities(s, sim.actions, sim.params)
    args = c._sphere_world_inputs(s.body_pos, fd["v"], fd["w"], fd["m"], fd["I_w"], sim.params,
                                  stp.h)
    tag = f"balls_terrain1080 F={args[1].shape[1]} no ground after {BALLS_TERRAIN_STEPS} steps"
    err = check_solve(sw, args, tag)
    check_repeatable(sw, args, tag)
    return err


def sdf_layer(c, state, params) -> None:
    """Ops and host ms (time_layers) of the SDF narrowphase alone, on its
    rows' shape poses: the part of the narrowphase that pile_layers and
    cube_layers time whole."""
    poses = c.shape_poses(state.body_pos, state.body_quat, params)
    fams = ", ".join("voxel" if fn is None else "closed form"
                     for _, fn in c._tables(state.body_pos.device).sdf.families)
    time_layers({f"SDF narrowphase ({fams})": lambda: c.sdf_rows(*poses)})


def nut_bolt_phase(kernels) -> None:
    """bench.py's nut_bolt@1024: a step with host syncs made errors,
    NUT_STEPS timed steps with the kernels' counts read around them (the
    sphere-world count must stay 0), every env's descent against
    test_nut_threads_down's bar, a profile, the SDF layers' ops and host
    ms, a TIG_DEBUG step, and 2 envs against nut_bolt_standin.npz."""
    from test_isaacgym_tpu_torch.envs.nut_bolt import NutBoltEnv
    from test_isaacgym_tpu_torch.utils import debug

    name = f"nut_bolt{NUT_ENVS}"
    t = time.perf_counter()
    env = NutBoltEnv(num_envs=NUT_ENVS, device=DEV)
    sim = env.sim
    c = sim.stepper.contact
    kinds = dict(zip(*np.unique(c.job.kind, return_counts=True)))
    log(f"{name}: {NUT_ENVS} envs built in {time.perf_counter() - t:.2f} s, {c.num_contacts} "
        f"contact rows an env (rows of each kind: {({int(k): int(v) for k, v in kinds.items()})}), "
        f"{c.sdf_probes.shape[1]} probes a pair direction")
    if 17 not in kinds or c.sphere_world is not None:
        raise RuntimeError(f"{name} has no SDF rows on the table")
    s0 = sim.state
    env.rollout(1, s0)  # warm
    log(f"{name}: {count_ops(lambda: env.rollout(1, s0))} non-view PyTorch ops a step")
    assert_sync_free(lambda: env.rollout(1, s0), name)
    s, step_ms, launches = timed(lambda: env.rollout(NUT_STEPS, s0), kernels, name, NUT_STEPS,
                                 NUT_ENVS, "env")
    if launches.get("sphere_world", 0):
        raise RuntimeError(f"{name} launched the sphere-world kernel: {launches}")
    assert_finite(s, name)
    dz = (env.nut_height(s) - env.nut_height(s0)).cpu().numpy()
    want = 2 * env.pitch * env.spin / (2 * np.pi)
    golden = np.load(port_data("nut_bolt_standin.npz"))
    log(f"{name} after {NUT_STEPS} steps: nut descent {dz.min():.6f} to {dz.max():.6f} m (mean "
        f"{dz.mean():.6f}), 2 pitches {want:.6f} (bound: within {NUT_RTOL:.0%}, spread < "
        f"{NUT_SPREAD}); JAX package on the CPU, the same {int(golden['big_envs'])} envs: "
        f"{float(golden['jax_descent_min']):.6f} to {float(golden['jax_descent_max']):.6f}")
    if not (np.abs(dz - want).max() <= NUT_RTOL * abs(want) and np.ptp(dz) < NUT_SPREAD):
        raise RuntimeError(f"{name}: a nut did not thread down two pitches")
    profile_steps(lambda st: env.rollout(10, st), s, step_ms, 10)
    pile_layers(sim, s)
    sdf_layer(c, s, sim.params)

    os.environ["TIG_DEBUG"] = "1"
    try:
        small = NutBoltEnv(num_envs=4, device=DEV)
        debug.verify_step_purity(small.sim.stepper, small._spun(small.sim.state),
                                 small.sim.actions, small.sim.params)
    finally:
        del os.environ["TIG_DEBUG"]
    log(f"{name}: verify_step_purity under TIG_DEBUG=1 passed (the table asserts on SDF rows)")

    small = NutBoltEnv(num_envs=int(golden["num_envs"]), device=DEV)
    every = int(golden["every"])
    worst = golden_err({"nut_pos": golden["nut_pos"], "nut_quat": golden["nut_quat"]},
                       small.sim.state,
                       lambda st: {"nut_pos": st.root_pos[:, small.nut_slot],
                                   "nut_quat": st.root_quat[:, small.nut_slot]},
                       lambda st: small.rollout(every, st))
    log(f"{name} {int(golden['num_envs'])} envs vs nut_bolt_standin.npz (nut pose every {every} "
        f"steps to step {every * (len(golden['nut_pos']) - 1)}): max |err| of largest "
        f"magnitude {worst:.3e}")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"{name} departs from its golden: {worst:.3e} > {GOLDEN_TOL}")


def franka_nut_bolt_phase(kernels) -> None:
    """The reference example's franka_nut_bolt at FNB_ENVS envs from the
    bolt start: a step with host syncs made errors, FNB_STEPS timed steps
    with the kernels' counts read around them (the sphere-world count must
    stay 0), the FSM shares and mean nut descent against the JAX env's, a
    profile, the layers' ops and host ms, and both starts at 2 envs
    against franka_nut_bolt_standin.npz, FSM states included."""
    from test_isaacgym_tpu_torch.envs.franka_nut_bolt import NUM_STATES, FrankaNutBoltEnv

    name = f"franka_nut_bolt{FNB_ENVS}"
    t = time.perf_counter()
    env = FrankaNutBoltEnv(num_envs=FNB_ENVS, start_on_bolt=True, device=DEV)
    c = env.sim.stepper.contact
    kinds = dict(zip(*np.unique(c.job.kind, return_counts=True)))
    log(f"{name}: {FNB_ENVS} envs built in {time.perf_counter() - t:.2f} s, {c.num_contacts} "
        f"contact rows an env (rows of each kind: {({int(k): int(v) for k, v in kinds.items()})}); "
        f"SDF grids on the device: {tuple(c.sdf_data.shape)} f32 "
        f"({c.sdf_data.nbytes / 1e6:.1f} MB)")
    if len(c.sdf_voxel_q) != 1 or len(c.sdf_analytic_groups) != 1:
        raise RuntimeError(f"{name} does not run both SDF families")
    ps = env.init_state
    env.rollout(1, ps)  # warm
    log(f"{name}: {count_ops(lambda: env.step_fn(ps))} non-view PyTorch ops a step")
    assert_sync_free(lambda: env.step_fn(ps), name)
    (end, (fsm_tr, _)), step_ms, launches = timed(lambda: env.rollout(FNB_STEPS, ps), kernels,
                                                   name, FNB_STEPS, FNB_ENVS, "env")
    if launches.get("sphere_world", 0):
        raise RuntimeError(f"{name} launched the sphere-world kernel: {launches}")
    assert_finite(end.sim, name)
    assert_in_limits(end.sim, env.sim.params, name)
    golden = np.load(port_data("franka_nut_bolt_standin.npz"))
    if int(golden["big_envs"]) != FNB_ENVS or int(golden["big_steps"]) != FNB_STEPS:
        raise RuntimeError(f"{name}: the golden's JAX numbers are of another run")
    shares = np.bincount(end.fsm.cpu().numpy(), minlength=NUM_STATES) / FNB_ENVS
    descent = float((env.nut_height_now(end) - env.nut_height_now(ps)).mean())
    jax_shares, jax_descent = golden["jax_shares"], float(golden["jax_descent"])
    log(f"{name} after {FNB_STEPS} steps: FSM shares {np.round(shares, 6).tolist()} (JAX env on "
        f"the CPU {np.round(jax_shares, 6).tolist()}), mean nut descent {descent:.6e} m (JAX "
        f"{jax_descent:.6e})")
    if np.abs(shares - jax_shares).max() > FNB_SHARE_SLACK:
        raise RuntimeError(f"{name}: FSM shares depart from the JAX env's by more than "
                           f"{FNB_SHARE_SLACK}")
    if abs(descent - jax_descent) > FNB_DESCENT_RTOL * abs(jax_descent):
        raise RuntimeError(f"{name}: mean nut descent {descent:.6e} not within "
                           f"{FNB_DESCENT_RTOL:.0%} of the JAX env's {jax_descent:.6e}")
    profile_steps(lambda st: env.rollout(5, st)[0], end, step_ms, 5)
    cube_layers(env, end)
    sdf_layer(c, end.sim, env.sim.params)

    for start in ("table", "bolt"):
        small = FrankaNutBoltEnv(num_envs=2, start_on_bolt=start == "bolt", device=DEV)
        n = int(golden[f"{start}_self_agree"])
        st, worst, fsm = small.init_state, 0.0, []
        for k in range(n + 1):
            for key, v in (("nut_pos", st.sim.root_pos[:, small.nut_slot]),
                           ("dof_pos", st.sim.dof_pos), ("dof_vel", st.sim.dof_vel)):
                want = golden[f"{start}_{key}"][k]
                err = float(np.abs(v.cpu().numpy() - want).max())
                worst = max(worst, err / max(float(np.abs(want).max()), 1.0))
            if k < n:
                st, (f, _) = small.step_fn(st)
                fsm.append(f.cpu().numpy())
        same = np.array_equal(np.asarray(fsm).reshape(n, 2), golden[f"{start}_fsm"])
        log(f"{name} {start} start, 2 envs vs franka_nut_bolt_standin.npz (nut_pos, dof_pos, "
            f"dof_vel every step to step {n}): max |err| of largest magnitude {worst:.3e}, FSM "
            f"states {'equal' if same else 'DIFFER'}")
        if worst > GOLDEN_TOL or not same:
            raise RuntimeError(f"{name} {start} departs from its golden")


def soft_layers(sim, state) -> None:
    """Ops and host ms (time_layers) of a substep's soft part (its XPBD
    iterations, friction and damping), of one XPBD iteration and of the
    collider projection inside it; and the soft part's device ms a step."""
    stp, params = sim.stepper, sim.params
    sf = stp.soft
    args = (state.soft_pos, state.soft_vel, state.body_pos, state.body_quat, params, stp.h,
            params.gravity)
    p, consts, lam_d, lam_h = sf.prepare(*args)
    time_layers({
        f"soft substep ({sf.iters} XPBD iterations, friction, damping)": lambda: sf.substep(*args),
        "one XPBD iteration (both tet constraints, the gather, the projection)":
            lambda: sf.iterate(p, lam_d, lam_h, consts),
        f"collider projection (ground and {len(sf.colliders)} colliders)":
            lambda: sf.collide(p, consts.colliders),
    })
    ms = device_ms(lambda: [sf.substep(*args) for _ in range(stp.substeps)], reps=2)
    log(f"  soft part's device time a step ({stp.substeps} substeps): "
        + (f"{ms:.3f} ms" if ms else "not measured"))


def soft_ends(sim, state):
    """(each env's lowest vertex height, each env's volume over the rest
    volume), numpy (N,), of the soft_body scene (Y-up)."""
    w = sim.scene.soft
    x = state.soft_pos[:, sim.stepper.soft.tets]
    d0, d1, d2 = (x[:, :, k] - x[:, :, 0] for k in (1, 2, 3))
    vol = (torch.linalg.cross(d0, d1, dim=-1) * d2).sum(-1).abs().sum(-1) / 6.0
    low = state.soft_pos[..., 1].amin(-1)
    return low.cpu().numpy(), (vol / float(w.rest_vol.sum())).cpu().numpy()


def soft_body_phase(kernels) -> None:
    """examples/soft_body.py at SOFT_ENVS envs: a step with host syncs made
    errors, SOFT_STEPS timed steps with the kernels' counts read around
    them (the sphere-world count must stay 0), every env's lowest vertex and
    volume ratio against their bounds and the JAX package's 1024 envs,
    tet_stress and tri_normals, two SOFT_REPEAT_STEPS runs bitwise equal, a
    profile, the soft layers' ops and host ms, a TIG_DEBUG step at 4 envs,
    and soft_body_standin.npz and soft_pedestals_standin.npz."""
    from test_isaacgym_tpu_torch.envs.soft_body import pedestals_sim, soft_body_sim
    from test_isaacgym_tpu_torch.utils import debug

    name = f"soft_body{SOFT_ENVS}"
    t = time.perf_counter()
    sim = soft_body_sim(SOFT_ENVS, device=DEV)
    stp, w = sim.stepper, sim.scene.soft
    log(f"{name}: {SOFT_ENVS} envs built in {time.perf_counter() - t:.2f} s, {w.num_verts} "
        f"vertices and {w.num_tets} tets an env, {len(w.col_kind)} collider(s) of kinds "
        f"{w.col_kind.tolist()} beside the ground, {stp.soft.iters} XPBD iterations a substep, "
        f"{stp.substeps} substeps a step")
    s0 = sim.state
    run = lambda st, n: stp.rollout(st, sim.actions, sim.params, n)  # noqa: E731
    run(s0, 1)  # warm
    log(f"{name}: {count_ops(lambda: run(s0, 1))} non-view PyTorch ops a step")
    assert_sync_free(lambda: run(s0, 1), name)
    s, step_ms, launches = timed(lambda: run(s0, SOFT_STEPS), kernels, name, SOFT_STEPS,
                                 SOFT_ENVS, "env")
    if launches.get("sphere_world", 0):
        raise RuntimeError(f"{name} launched the sphere-world kernel: {launches}")
    assert_finite(s, name)

    golden = np.load(port_data("soft_body_standin.npz"))
    if int(golden["big_envs"]) != SOFT_ENVS or int(golden["big_steps"]) != SOFT_STEPS:
        raise RuntimeError(f"{name}: the golden's JAX numbers are of another run")
    low, vol = soft_ends(sim, s)
    stiff = sim.params.soft_youngs[:, 0].cpu().numpy() >= SOFT_BOUND_YOUNGS
    out = (vol <= SOFT_VOLUME[0]) | (vol >= SOFT_VOLUME[1])
    jax_out = (golden["jax_volume"] <= SOFT_VOLUME[0]) | (golden["jax_volume"] >= SOFT_VOLUME[1])
    log(f"{name} after {SOFT_STEPS} steps: lowest vertex {low.min():.6f} to {low.max():.6f} m "
        f"(bound {SOFT_LOWEST}); volume ratio out of {SOFT_VOLUME} in {int(out[stiff].sum())} of "
        f"{int(stiff.sum())} envs of Young's >= {SOFT_BOUND_YOUNGS:g} and {int(out[~stiff].sum())} of "
        f"the {int((~stiff).sum())} softer (JAX package: {int(jax_out[stiff].sum())} and "
        f"{int(jax_out[~stiff].sum())})")
    if not ((low > SOFT_LOWEST[0]) & (low < SOFT_LOWEST[1])).all() or out[stiff].any():
        raise RuntimeError(f"{name}: an env left the lowest-vertex bounds {SOFT_LOWEST} or the "
                           f"volume bounds {SOFT_VOLUME}")
    for what, got, want, agree, fns in (
            ("lowest vertex", low, golden["jax_lowest"],
             np.abs(golden["agree_lowest_jit"] - golden["agree_lowest_opbyop"]).max(),
             (np.min, np.mean)),
            ("volume ratio", vol, golden["jax_volume"],
             np.abs(golden["agree_volume_jit"] - golden["agree_volume_opbyop"]).max(),
             (np.min, np.mean, np.max))):
        slack = SOFT_SLACK_FACTOR * float(agree)
        stats = np.array([f(got[stiff]) for f in fns])
        jstats = np.array([f(want[stiff]) for f in fns])
        log(f"{name}: {what} {'/'.join(f.__name__ for f in fns)} over the {int(stiff.sum())} "
            f"stiffer envs {stats.round(6).tolist()} (max {got[stiff].max():.6f}); JAX "
            f"package, the same envs on the CPU {jstats.round(6).tolist()} (max "
            f"{want[stiff].max():.6f}); slack {slack:.3e} ({SOFT_SLACK_FACTOR:g} x its "
            f"jitted-vs-op-by-op {agree:.3e}); largest per-env difference "
            f"{np.abs(got - want)[stiff].max():.3e}")
        if np.abs(stats - jstats).max() > slack:
            raise RuntimeError(f"{name}: the {what} departs from the JAX package's")
    sf = stp.soft
    stress = sf.tet_stress(s.soft_pos, sim.params)
    asym = float((stress - stress.transpose(-1, -2)).abs().max())
    unit = float((sf.tri_normals(s.soft_pos).norm(dim=-1) - 1.0).abs().max())
    log(f"{name}: tet_stress {tuple(stress.shape)} finite {bool(torch.isfinite(stress).all())}, "
        f"asymmetry {asym:.3e}; tri_normals' largest | |n| - 1 | {unit:.3e}")
    if not (torch.isfinite(stress).all() and asym < 1e-2 and unit < 1e-5):
        raise RuntimeError(f"{name}: tet_stress or tri_normals are wrong")

    a, b = run(s0, SOFT_REPEAT_STEPS), run(s0, SOFT_REPEAT_STEPS)
    diff = max(float((x - y).abs().max()) for x, y in zip(a, b)
               if x is not None and x.is_floating_point())
    log(f"{name}: two {SOFT_REPEAT_STEPS}-step runs differ by {diff}")
    if diff != 0.0:
        raise RuntimeError(f"{name} is not bitwise repeatable")
    profile_steps(lambda st: run(st, SOFT_PROFILE_STEPS), s, step_ms, SOFT_PROFILE_STEPS)
    soft_layers(sim, s)

    os.environ["TIG_DEBUG"] = "1"
    try:
        small = soft_body_sim(4, device=DEV)
        debug.verify_step_purity(small.stepper, small.state, small.actions, small.params)
    finally:
        del os.environ["TIG_DEBUG"]
    log(f"{name}: verify_step_purity under TIG_DEBUG=1 passed at 4 envs")

    for path, small in (("soft_body_standin.npz", soft_body_sim(int(golden["num_envs"]), DEV)),
                        ("soft_pedestals_standin.npz", pedestals_sim(DEV))):
        g = np.load(port_data(path))
        worst = golden_err({"soft_pos": g["soft_pos"]}, small.state,
                           lambda st: {"soft_pos": st.soft_pos},
                           lambda st: small.stepper.step(st, small.actions, small.params))
        log(f"{name}: {path} ({small.scene.num_envs} env(s), soft_pos every step to step "
            f"{len(g['soft_pos']) - 1}): max |err| of largest magnitude {worst:.3e}")
        if worst > GOLDEN_TOL:
            raise RuntimeError(f"{name} departs from {path}: {worst:.3e} > {GOLDEN_TOL}")


def ant_stats(obs, reset):
    """(share of envs that reset at some step, share that left the scene,
    mean torso height of the others) of the last observation (N, 27) and
    the per-env reset flags: an env has left when its observation is not
    finite or its torso is over LEFT_HEIGHT (tools/make_rl_goldens.py's
    ant_stats, on tensors)."""
    left = ~torch.isfinite(obs).all(-1) | (obs[:, 0] > LEFT_HEIGHT)
    return (float(reset.float().mean()), float(left.float().mean()),
            float(obs[~left, 0].mean())), left


def frame_check(what, rgba, seg, want_rgb, want_seg):
    """render()'s frame against a JAX frame: per-shape segmentation equal,
    colour within one count, all but FRAME_SHARE of the pixels."""
    rgb = rgba[..., :3].cpu().numpy()
    if rgb.dtype != np.uint8 or rgb.shape != want_rgb.shape or rgb.std() == 0:
        raise RuntimeError(f"{what}: frame {rgb.shape} {rgb.dtype} std {rgb.std()}")
    seg_bad = seg.cpu().numpy() != want_seg
    col_bad = np.abs(rgb.astype(np.int32) - want_rgb.astype(np.int32)).max(-1) > 1
    bad = seg_bad | col_bad
    log(f"{what}: frame {rgb.shape} uint8 std {rgb.std():.2f}; segmentation differs on "
        f"{seg_bad.mean():.5f}, colour by more than one count where it agrees on "
        f"{(col_bad & ~seg_bad).mean():.5f} of the pixels (bound {FRAME_SHARE})")
    if bad.mean() > FRAME_SHARE:
        raise RuntimeError(f"{what}: the frame departs from the JAX package's")


def ant_phase(kernels) -> None:
    """make(task="Ant") at ANT_ENVS envs: a step with host syncs made errors,
    ANT_STEPS timed steps of RandomState(0) actions already on the card with
    the kernels' counts read around them (the sphere-world count must stay
    0), the state of the envs still in the scene finite and in their joint
    limits, the statistics against the JAX package's, a profile, the 4-env
    golden and render() of env 0 against the JAX frame."""
    from test_isaacgym_tpu_torch.envs import rl_env

    name = f"ant{ANT_ENVS}"
    t = time.perf_counter()
    env = rl_env.make(task="Ant", num_envs=ANT_ENVS, sim_device=DEV, rl_device=DEV)
    log(f"{name}: {ANT_ENVS} envs built in {time.perf_counter() - t:.2f} s, "
        f"{env.sim.stepper.contact.num_contacts} contact rows an env")
    acts = torch.as_tensor(np.random.RandomState(0).uniform(-1, 1, (ANT_STEPS, ANT_ENVS, 8))
                           .astype(np.float32), device=DEV)
    env.reset()
    env.step(acts[0])  # warm
    log(f"{name}: {count_ops(lambda: env.step(acts[0]))} non-view PyTorch ops a step")
    assert_sync_free(lambda: env.step(acts[0]), name)

    def run():
        env.reset()
        reset = torch.zeros(ANT_ENVS, dtype=torch.bool, device=DEV)
        for k in range(ANT_STEPS):
            obs, _, done, _ = env.step(acts[k])
            reset |= done
        return obs, reset, done

    (obs, reset, done), step_ms, launches = timed(run, kernels, name, ANT_STEPS, ANT_ENVS, "env")
    if launches.get("sphere_world", 0):
        raise RuntimeError(f"{name} launched the sphere-world kernel: {launches}")
    (share, left_share, height), left = ant_stats(obs, reset)
    s = env.state
    for key, v in s._asdict().items():
        if (v is not None and v.is_floating_point() and v.dim() and v.shape[0] == ANT_ENVS
                and not torch.isfinite(v[~left]).all()):
            raise RuntimeError(f"{name} state.{key} is not finite in an env still in the scene")
    # an env reset by the last step holds the initial state, whose DOFs are
    # 0 (the JAX env's too), outside the ankles' ranges (30..100 degrees)
    if not torch.equal(s.dof_pos[done], env.sim.initial_state.dof_pos[done]):
        raise RuntimeError(f"{name}: an env reset by the last step is not at its initial state")
    keep = ~done & ~left
    p, q = env.sim.params, s.dof_pos[keep]
    out = p.dof_has_limits[keep] & ((q < p.dof_lower[keep]) | (q > p.dof_upper[keep]))
    if out.any():
        raise RuntimeError(f"{name}: dof_pos left its joint limits in {int(out.any(-1).sum())} envs")
    log(f"{name} after {ANT_STEPS} steps: {int(reset.sum())} envs reset at some step "
        f"(auto-resets; {int(done.sum())} by the last one, at their initial state), "
        f"{int(left.sum())} left the scene; the others in the scene in their joint limits")
    g = np.load(port_data("ant_standin.npz"))
    if int(g["big_envs"]) != ANT_ENVS or int(g["big_steps"]) != ANT_STEPS:
        raise RuntimeError(f"{name}: the golden's JAX statistics are of another run")
    for what, got in (("reset share", share), ("left share", left_share),
                      ("mean torso height of the others", height)):
        key = {"reset share": "reset", "left share": "left"}.get(what, "height")
        jit, op = float(g[f"big_{key}_jit"]), float(g[f"big_{key}_opbyop"])
        slack = ANT_SLACK_FACTOR * abs(jit - op)
        log(f"{name}: {what} {got:.6f}; JAX package {jit:.6f} jitted, {op:.6f} op by op; "
            f"slack {slack:.6f} ({ANT_SLACK_FACTOR:g} x their difference)")
        if abs(got - jit) > slack:
            raise RuntimeError(f"{name}: the {what} departs from the JAX package's")
    profile_steps(lambda st: [env.step(a) for a in acts[:ANT_PROFILE_STEPS]], None, step_ms,
                  ANT_PROFILE_STEPS)

    small = rl_env.make(task="Ant", num_envs=int(g["num_envs"]), sim_device=DEV, rl_device=DEV)
    small.reset()
    errs = []
    for k in range(int(g["horizon"])):
        o, r, d, _ = small.step(g["actions"][k])
        errs.append(max(rel_err(o, g["obs"][k]), rel_err(r, g["reward"][k])))
        if not np.array_equal(d.cpu().numpy(), g["done"][k]):
            raise RuntimeError(f"{name}: done departs from the golden at step {k + 1}")
    worst = max(errs)
    log(f"{name}: {int(g['num_envs'])} envs vs ant_standin.npz (obs, reward every step to the "
        f"horizon {int(g['horizon'])}): max |err| of largest magnitude {worst:.3e} (step "
        f"{int(np.argmax(errs)) + 1}; every 8th step: "
        f"{', '.join(f'{e:.1e}' for e in errs[7::8])})")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"{name} departs from the golden: {worst:.3e} > {GOLDEN_TOL}")
    frame = small.render()
    rgba, _, seg = small.camera_images(seg=np.arange(1, len(small._rtables.kind) + 1,
                                                      dtype=np.int32))
    if not np.array_equal(frame, rgba[..., :3].cpu().numpy()):
        raise RuntimeError(f"{name}: render() is not camera_images()'s colour")
    frame_check(f"{name} render()", rgba, seg, g["frame"], g["frame_seg"])


def reach_phase(kernels) -> None:
    """make(task="Franka") at REACH_ENVS envs: a step with host syncs made
    errors, REACH_STEPS timed steps with the kernels' counts read around them
    (the sphere-world count must stay 0), the state finite and in its limits,
    and the 8-env golden."""
    from test_isaacgym_tpu_torch.envs import rl_env

    name = f"franka_reach{REACH_ENVS}"
    t = time.perf_counter()
    env = rl_env.make(task="Franka", num_envs=REACH_ENVS, sim_device=DEV, rl_device=DEV)
    log(f"{name}: {REACH_ENVS} envs built in {time.perf_counter() - t:.2f} s")
    acts = torch.as_tensor(np.random.RandomState(0).uniform(-1, 1, (REACH_STEPS, REACH_ENVS, 7))
                           .astype(np.float32), device=DEV)
    env.reset()
    env.step(acts[0])  # warm
    log(f"{name}: {count_ops(lambda: env.step(acts[0]))} non-view PyTorch ops a step")
    assert_sync_free(lambda: env.step(acts[0]), name)

    def run():
        env.reset()
        for k in range(REACH_STEPS):
            obs, rew, _, _ = env.step(acts[k])
        return obs, rew

    (obs, rew), step_ms, launches = timed(run, kernels, name, REACH_STEPS, REACH_ENVS, "env")
    if launches.get("sphere_world", 0):
        raise RuntimeError(f"{name} launched the sphere-world kernel: {launches}")
    assert_finite(env.state, name)
    assert_in_limits(env.state, env.sim.params, name)
    log(f"{name}: mean reward after {REACH_STEPS} steps {float(rew.mean()):.6f}")

    g = np.load(port_data("franka_reach_standin.npz"))
    n, every = int(g["num_envs"]), int(g["every"])
    small = rl_env.make(task="Franka", num_envs=n, sim_device=DEV, rl_device=DEV)
    sa = np.random.RandomState(0).uniform(-1, 1, (int(g["steps"]), n, 7)).astype(np.float32)
    worst = rel_err(small.reset(), g["obs"][0])
    for k in range(int(g["steps"])):
        o, r, _, _ = small.step(sa[k])
        if (k + 1) % every == 0:
            i = (k + 1) // every
            worst = max(worst, rel_err(o, g["obs"][i]), rel_err(r, g["reward"][i]))
    log(f"{name}: {n} envs vs franka_reach_standin.npz (obs, reward every {every} steps): "
        f"max |err| of largest magnitude {worst:.3e}")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"{name} departs from the golden: {worst:.3e} > {GOLDEN_TOL}")


def no_kernel_launches(kernels, what) -> None:
    """The hand-written kernels' counts of a run of a path that has none:
    recorded by path, and each must be 0."""
    launches = dict(kernels.launches)
    PATH_LAUNCHES[what] = launches.get("sphere_world", 0)
    log(f"{what}: sphere_world launches {PATH_LAUNCHES[what]}")
    if any(launches.values()):
        raise RuntimeError(f"{what} launched hand-written kernels: {launches}")


def nut_scene_render(raster, sim, tb, width, height, seg=None):
    """One package's render of env 0 of a FrankaNutBoltEnv sim from
    bench.py's render camera: (rgba, depth, seg) of that env, each with the
    env axis. `raster` is the package's render.raster module and `tb` its
    tables of the scene (built once, as a viewer does); `seg` (S,) replaces
    the scene's segmentation ids. tools/make_rl_goldens.py calls it with the
    JAX package's module."""
    from test_isaacgym_tpu_torch.render.camera import look_at_quat

    sp, sq = raster.shape_world_poses(sim.state, sim.params, tb, sim.scene)
    org = np.asarray(sim.scene.env_origins[0], np.float32)
    eye = (np.asarray(RENDER_EYE, np.float32) + org)[None]
    quat = look_at_quat(RENDER_EYE, RENDER_TARGET).astype(np.float32)[None]
    g = sim.scene.ground
    ground = np.array([*np.asarray(g.normal, np.float32) / np.linalg.norm(g.normal), g.distance],
                      np.float32)
    light = (np.array([-0.3, -0.3, -0.9], np.float32) / np.linalg.norm([0.3, 0.3, 0.9]),
             np.full(3, 0.8, np.float32), np.full(3, 0.25, np.float32),
             np.array([0.32, 0.45, 0.6], np.float32))
    kw = dict(mesh_rows=tuple(int(r) for r in tb.mesh_rows), mesh_planes=tb.mesh_planes,
              mesh_base=tb.mesh_base, tri_shape=tuple(int(r) for r in tb.tri_shape),
              tri_v=tb.tri_v, tri_n=tb.tri_n,
              tri_base=tuple(tuple(float(x) for x in row)
                             for row in np.asarray(sim.scene.shapes.size, np.float32)))
    if torch.is_tensor(sp):  # the port: tensors on the sim's device
        eye, quat = (torch.as_tensor(x, device=sp.device) for x in (eye, quat))
    return raster.render_camera_batch(
        eye, quat, sp[:1], sq[:1], sim.params.shape_size[:1], tb.kind, tb.color,
        tb.seg if seg is None else seg, ground, *light, 90.0, width=width, height=height,
        far=100.0, **kw)[:3]


def render_phase(kernels) -> None:
    """bench.py's render config on one env of the FrankaNutBoltEnv scene:
    the tables hold triangle and hull rows, RENDER_FRAMES timed frames at
    RENDER_SIZE, two frames bitwise equal, and RENDER_SMALL of the same
    camera against render_standin.npz."""
    from test_isaacgym_tpu_torch.envs.franka_nut_bolt import FrankaNutBoltEnv
    from test_isaacgym_tpu_torch.render import raster

    w, h = RENDER_SIZE
    name = f"render{w}x{h}"
    sim = FrankaNutBoltEnv(num_envs=1, device=DEV).sim
    tb = raster.tables_from_scene(sim.scene)
    log(f"{name}: {len(tb.kind)} shapes, {len(tb.tri_shape)} visual triangles (of shape rows "
        f"{sorted(set(tb.tri_shape.tolist()))}), {len(tb.mesh_rows)} hull rows of "
        f"{tb.mesh_planes.shape[1]} planes")
    if not (len(tb.tri_shape) and len(tb.mesh_rows)):
        raise RuntimeError(f"{name}: the scene's tables lack triangle or hull rows")
    seg = np.arange(1, len(tb.kind) + 1, dtype=np.int32)
    frame = lambda: nut_scene_render(raster, sim, tb, w, h, seg)  # noqa: E731
    first = frame()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t = time.perf_counter()
    for _ in range(RENDER_FRAMES):
        out = frame()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / RENDER_FRAMES * 1e3
    no_kernel_launches(kernels, name)
    hit = float(torch.isfinite(out[1]).float().mean())
    log(f"{name}: {ms:.4f} ms/frame over {RENDER_FRAMES} frames ({w * h} rays a frame), "
        f"{hit:.4f} of the pixels hit, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(torch.equal(a, b) for a, b in zip(first, out)):
        raise RuntimeError(f"{name}: two frames of the same scene differ")
    log(f"{name}: {count_ops(frame)} non-view PyTorch ops a frame")
    profile_steps(lambda _: frame(), None, ms, 1, "frame")

    g = np.load(port_data("render_standin.npz"))
    rgba, depth, seg_img = (x[0] for x in nut_scene_render(raster, sim, tb, *RENDER_SMALL, seg))
    frame_check(f"{name} at {RENDER_SMALL[0]}x{RENDER_SMALL[1]}", rgba, seg_img,
                g["rgba"][..., :3], g["seg"])
    d, wd = depth.cpu().numpy(), g["depth"]
    both = np.isfinite(d) & np.isfinite(wd)
    derr = float(np.abs(np.where(both, d, 0.0) - np.where(both, wd, 0.0)).max())
    log(f"{name}: depth where both hit within {derr:.3e} m")


def camera_phase(kernels) -> None:
    """A CAMERA_SIZE CameraSensor on each of ANT_ENVS Ant envs: CAMERA_FRAMES
    frames, each after randomize_colors, randomize_light and
    randomize_camera_pose drawn from a generator on the card; timed; a second
    run from the same seed bitwise equal."""
    from test_isaacgym_tpu_torch import randomize as dr
    from test_isaacgym_tpu_torch.core.config import CameraProperties
    from test_isaacgym_tpu_torch.envs import rl_env
    from test_isaacgym_tpu_torch.render import raster
    from test_isaacgym_tpu_torch.render.camera import CameraSensor

    w, h = CAMERA_SIZE
    name = f"ant_camera{ANT_ENVS}"
    env = rl_env.make(task="Ant", num_envs=ANT_ENVS, sim_device=DEV, rl_device=DEV)
    env.reset()
    sim, st = env.sim, env.state
    tb = raster.tables_from_scene(sim.scene)
    sp, sq = raster.shape_world_poses(st, sim.params, tb, sim.scene)
    base = torch.as_tensor(tb.color, device=DEV).expand(ANT_ENVS, -1, -1)
    origins = sim.env_origins
    cam = CameraSensor(props=CameraProperties(width=w, height=h), num_envs=ANT_ENVS, device=DEV)
    bg, ground = np.array([0.32, 0.45, 0.6], np.float32), np.array([0, 0, 1, 0], np.float32)

    def frames():
        gen = torch.Generator(device=DEV).manual_seed(0)
        out = []
        for _ in range(CAMERA_FRAMES):
            colors = dr.randomize_colors(gen, base)
            light, ambient, d = dr.randomize_light(gen, DEV)
            pos, tgt = dr.randomize_camera_pose(gen, ANT_ENVS, (0.0, 0.0, 0.4), device=DEV)
            cam.set_locations(pos, tgt)
            cp, cq = cam.world_pose(st, origins)
            out.append(raster.render_camera_batch(
                cp, cq, sp, sq, sim.params.shape_size, tb.kind, colors, tb.seg, ground, d,
                light, ambient, bg, cam.props.horizontal_fov, width=w, height=h, far=100.0)[:3])
        return out

    frames()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t = time.perf_counter()
    a = frames()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    no_kernel_launches(kernels, name)
    log(f"{name}: {CAMERA_FRAMES} frames of {ANT_ENVS} {w}x{h} cameras in {wall:.3f} s: "
        f"{wall / CAMERA_FRAMES * 1e3:.4f} ms/frame, {ANT_ENVS * CAMERA_FRAMES / wall:.1f} "
        f"env-frames/s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{name}: {count_ops(frames) // CAMERA_FRAMES} non-view PyTorch ops a frame "
        "(randomizers included)")
    profile_steps(lambda _: frames(), None, wall / CAMERA_FRAMES * 1e3, CAMERA_FRAMES, "frame")
    rgba = a[-1][0]
    hit = float(torch.isfinite(a[-1][1]).float().mean())
    log(f"{name}: last frame {tuple(rgba.shape)} {rgba.dtype}, {hit:.4f} of the pixels hit, "
        f"colour std {float(rgba[..., :3].float().std()):.2f}")
    if rgba.shape != (ANT_ENVS, h, w, 4) or rgba.dtype != torch.uint8 or hit == 0.0:
        raise RuntimeError(f"{name}: the frames are wrong")
    b = frames()
    if not all(torch.equal(x, y) for fa, fb in zip(a, b) for x, y in zip(fa, fb)):
        raise RuntimeError(f"{name}: two runs from the same seed differ")
    log(f"{name}: two runs of {CAMERA_FRAMES} frames from the same seed are bitwise equal")


def cube_phase(kernels) -> None:
    """The franka_cube pick path at CUBE_ENVS envs under OSC: a timed run
    with the hand-written kernels' counts read around it (the path has none,
    so every count must stay 0), checks of its end state, a step with host
    syncs made errors, per-layer ops and host ms, a profile, the 4-env
    golden of both controllers, and the grip and lift shares."""
    from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT
    from test_isaacgym_tpu_torch.envs.franka_cube import BOX_SIZE, TABLE_DIMS, FrankaCubeEnv

    t = time.perf_counter()
    env = FrankaCubeEnv(num_envs=CUBE_ENVS, controller="osc", device=DEV)
    log(f"franka_cube: {CUBE_ENVS} envs built in {time.perf_counter() - t:.2f} s, "
        f"{env.sim.stepper.contact.num_contacts} contact rows an env")
    ps = env.init_state
    env.rollout_fn(1)(ps)  # warm: allocator and library handles
    one = env.rollout_fn(1)
    log(f"franka_cube: {count_ops(lambda: one(ps))} non-view PyTorch ops a step")
    assert_sync_free(lambda: one(ps), "franka_cube")

    run = env.rollout_fn(CUBE_STEPS)
    (end, (gripped, box_z)), step_ms, launches = timed(lambda: run(ps), kernels, "franka_cube",
                                                       CUBE_STEPS, CUBE_ENVS, "env")
    if any(launches.values()):
        raise RuntimeError(f"the franka_cube path launched hand-written kernels: {launches}")
    s = end.sim
    assert_finite(s, "franka_cube")
    assert_in_limits(s, env.sim.params, "franka_cube")
    bottom = s.root_pos[:, env.box_slot, 2] - 0.5 * BOX_SIZE
    low = float(bottom.min())
    sunk = int((bottom < TABLE_DIMS[2] - 0.01).sum())
    log(f"franka_cube lowest cube bottom after {CUBE_STEPS} steps: {low:.6f} m (table top "
        f"{TABLE_DIMS[2]}, JAX env {JAX_CUBE_BOTTOM:.6f}); {sunk} cubes more than 1 cm "
        "into the table")
    if not (low > JAX_CUBE_BOTTOM - CUBE_SINK_SLACK and low > 0.0):
        raise RuntimeError(f"a cube sank deeper than the JAX env's: bottom {low:.6f} m")

    g, z = gripped.cpu().numpy(), box_z.cpu().numpy()
    lifted = g & (z > TABLE_DIMS[2] + 0.1)
    grip, lift = float(g.any(0).mean()), float(lifted.any(0).mean())
    log(f"franka_cube shares after {CUBE_STEPS} steps of {CUBE_ENVS} envs: grip {grip:.6f}, "
        f"lift {lift:.6f} (JAX env: grip {JAX_GRIP_SHARE:.6f}, lift {JAX_LIFT_SHARE:.6f})")
    if grip < JAX_GRIP_SHARE - CUBE_SHARE_SLACK or lift < JAX_LIFT_SHARE - CUBE_SHARE_SLACK:
        raise RuntimeError(f"franka_cube grips or lifts less than the JAX env: {grip}, {lift}")

    profile_steps(env.rollout_fn(CUBE_PROFILE_STEPS), end, step_ms, CUBE_PROFILE_STEPS)
    cube_layers(env, end)

    golden = np.load(os.path.join(STANDIN_ROOT, "franka_cube_standin.npz"))
    for ctrl in ("ik", "osc"):
        small = FrankaCubeEnv(num_envs=CUBE_GOLDEN_ENVS, controller=ctrl, device=DEV)
        chunk = small.rollout_fn(CUBE_GOLDEN_EVERY)
        worst = golden_err({k: golden[f"{ctrl}_{k}"] for k in ("box_pos", "dof_pos")},
                           small.init_state,
                           lambda st: {"box_pos": st.sim.root_pos[:, small.box_slot],
                                       "dof_pos": st.sim.dof_pos},
                           lambda st: chunk(st)[0])
        log(f"franka_cube {ctrl} {CUBE_GOLDEN_ENVS} envs vs stand-in golden (box_pos, dof_pos "
            f"every {CUBE_GOLDEN_EVERY} steps): max |err| of largest magnitude {worst:.3e}")
        if worst > GOLDEN_TOL:
            raise RuntimeError(f"franka_cube {ctrl} departs from the golden: {worst:.3e} > {GOLDEN_TOL}")


def gym_balls_phase(kernels) -> None:
    """The 1080 balls built through gym calls (one create_env, a
    create_actor a ball) in one env: GYM_BALL_STEPS steps of simulate +
    refresh_actor_root_state_tensor with the kernels' counts read around
    them (exactly 2 sphere-world launches a step), balls1080's bounds read
    from the wrapped root and contact tensors, the root tensor's storage
    unchanged by the refreshes, a step with host syncs made errors, a
    profile, the KEY_R snapshot reset restoring the first state bit for
    bit, and the 120-ball run against gym_balls_standin.npz."""
    from test_isaacgym_tpu_torch import gymapi, gymtorch
    from test_isaacgym_tpu_torch.envs import gym_scenes
    from test_isaacgym_tpu_torch.ops.sphere_world import LAUNCHES_PER_SOLVE

    name = "gym_balls1080"
    t = time.perf_counter()
    gym, sim, env = gym_scenes.balls(gymapi, 36, {"device": DEV})
    snapshot = np.copy(gym.get_sim_rigid_body_states(sim, gymapi.STATE_ALL))
    root = gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim))
    contact = gymtorch.wrap_tensor(gym.acquire_net_contact_force_tensor(sim))
    torch.cuda.synchronize()
    F, first, ptr = root.shape[0], root.clone(), root.data_ptr()
    log(f"{name}: {F} balls built through gym calls in {time.perf_counter() - t:.2f} s")

    def step():
        gym.simulate(sim)
        gym.refresh_actor_root_state_tensor(sim)

    def run():
        for _ in range(GYM_BALL_STEPS):
            step()

    _, step_ms, launches = timed(run, kernels, name, GYM_BALL_STEPS, F, "ball")
    want = GYM_BALL_STEPS * LAUNCHES_PER_SOLVE
    if launches.get("sphere_world", 0) != want:
        raise RuntimeError(f"{name} launched the kernel {launches} times, want {want}")
    gym.refresh_net_contact_force_tensor(sim)
    zmin, zmax = float(root[:, 2].min()), float(root[:, 2].max())
    fz = float(contact[:, 2].max())
    log(f"{name} end state (wrapped root tensor): zmin {zmin:.4f} zmax {zmax:.4f} max ground "
        f"force {fz:.4f}; the tensor's data_ptr unchanged: {root.data_ptr() == ptr}")
    if not (zmin > 0.15 and zmax < 3.0 and fz > 0):
        raise RuntimeError(f"{name} sank, exploded or lost ground support")
    if root.data_ptr() != ptr or root.device.type != torch.device(DEV).type:
        raise RuntimeError(f"{name}: the wrapped root tensor moved or left the card")
    log(f"{name}: {count_ops(step)} non-view PyTorch ops a step (simulate + refresh)")
    assert_sync_free(lambda: (step(), gym.set_actor_root_state_tensor(sim, root)), name)
    profile_steps(lambda _: [step() for _ in range(PROFILE_STEPS)], None, step_ms, PROFILE_STEPS)

    viewer = gym.create_viewer(sim, gymapi.CameraProperties())
    gym.subscribe_viewer_keyboard_event(viewer, gymapi.KEY_R, "reset")
    viewer.inject_event(gymapi.KEY_R)
    for ev in gym.query_viewer_action_events(viewer):
        if ev.action == "reset":
            gym.set_sim_rigid_body_states(sim, snapshot, gymapi.STATE_ALL)
    gym.refresh_actor_root_state_tensor(sim)
    if not torch.equal(root, first):
        raise RuntimeError(f"{name}: the KEY_R snapshot reset did not restore the first state")
    log(f"{name}: the KEY_R snapshot reset restored the first state bit for bit")

    g = np.load(port_data("gym_balls_standin.npz"))
    every = int(g["every"])
    gym, sim, env = gym_scenes.balls(gymapi, 4, {"device": DEV})
    small = gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim))

    def advance(_):
        for _ in range(every):
            gym.simulate(sim)
        gym.refresh_actor_root_state_tensor(sim)
        return small

    worst = golden_err({"pos": g["pos"]}, small, lambda r: {"pos": r[:, :3]}, advance)
    log(f"{name}: {small.shape[0]} balls vs gym_balls_standin.npz (positions every {every} steps "
        f"to {every * (len(g['pos']) - 1)}): max |err| of largest magnitude {worst:.3e}")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"{name}: the 120-ball run departs from the golden: {worst:.3e}")


def gym_franka_osc_phase(kernels) -> None:
    """examples/franka_osc.py through the facade at GYM_OSC_ENVS envs on the
    Panda stand-in: the build's seconds, GYM_OSC_STEPS steps of the
    example's loop (refresh the rigid-body, DOF, Jacobian and mass-matrix
    tensors, the OSC on the card, set_dof_actuation_force_tensor, simulate,
    fetch_results) with the kernels' counts read around them (none), the
    mean tracking error, a step with host syncs made errors, a profile, the
    native FrankaOscEnv's ms/step beside it, and 8 envs against
    gym_franka_osc_standin.npz."""
    from test_isaacgym_tpu_torch import gymapi, gymtorch
    from test_isaacgym_tpu_torch.envs import gym_scenes

    name = f"gym_franka_osc{GYM_OSC_ENVS}"
    t = time.perf_counter()
    gym, sim, scene = gym_scenes.franka_osc(gymapi, GYM_OSC_ENVS, sim_kw={"device": DEV})
    t_calls = time.perf_counter() - t
    loop = gym_scenes.OscLoop(gym, gymapi, gymtorch, sim, scene)
    torch.cuda.synchronize()
    log(f"{name}: built in {time.perf_counter() - t:.2f} s ({t_calls:.2f} s of per-env gym "
        f"calls, the rest prepare_sim and the tensor handles)")
    dof0 = loop.dof.clone()
    for itr in range(2):  # warm: allocator and library handles
        loop.step(itr)
    gym.set_dof_state_tensor(sim, dof0)
    loop.err_sum.zero_()
    loop.err_steps = 0

    def run():
        for itr in range(GYM_OSC_STEPS):
            loop.step(itr)

    _, step_ms, launches = timed(run, kernels, name, GYM_OSC_STEPS, GYM_OSC_ENVS, "env")
    if any(launches.values()):
        raise RuntimeError(f"{name} launched hand-written kernels: {launches}")
    s = sim.sim.state
    assert_finite(s, name)
    g = np.load(port_data("gym_franka_osc_standin.npz"))
    err, jax_err = loop.mean_error(), float(g["track_err"])
    log(f"{name}: mean tracking error after step {gym_scenes.OSC_SETTLE} {err:.6f} m (bound "
        f"{GYM_OSC_BOUND}; the JAX facade's 8 envs {jax_err:.6f}, within {GYM_OSC_RTOL:.0%})")
    if not (err < GYM_OSC_BOUND and abs(err - jax_err) <= GYM_OSC_RTOL * jax_err):
        raise RuntimeError(f"{name}: tracking error {err:.6f} m")
    log(f"{name}: {count_ops(lambda: loop.step(0, fetch=False))} non-view PyTorch ops a step "
        "(refreshes, the example's OSC, set, simulate)")
    loop.refresh()
    u = loop.torque(0)[2]

    def sync_free_step():
        loop.refresh()
        gym.set_dof_actuation_force_tensor(sim, gymtorch.unwrap_tensor(u))
        gym.simulate(sim)

    assert_sync_free(sync_free_step, name)
    profile_steps(lambda _: [loop.step(i) for i in range(3)], None, step_ms, 3)

    native = STEP_MS.get("franka")
    if native is None:
        from test_isaacgym_tpu_torch.envs.franka import FrankaOscEnv

        env = FrankaOscEnv(num_envs=GYM_OSC_ENVS, device=DEV)
        env.rollout_fn(2)(env.sim.state)
        run_native = env.rollout_fn(NATIVE_STEPS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_native(env.sim.state)
        torch.cuda.synchronize()
        native = (time.perf_counter() - t) / NATIVE_STEPS * 1e3
        del env
    log(f"{name}: {step_ms:.4f} ms/step through the facade; the native FrankaOscEnv "
        f"{native:.4f} ms/step in this call: {step_ms / native:.3f}x")

    n, every = int(g["num_envs"]), int(g["every"])
    gym, sim, scene = gym_scenes.franka_osc(gymapi, n, sim_kw={"device": DEV})
    small = gym_scenes.OscLoop(gym, gymapi, gymtorch, sim, scene)
    worst = 0.0
    for itr in range(every * (len(g["hand_pos"]) - 1) + 1):
        if itr % every == 0:
            snap = small.snapshot()
            for key in ("hand_pos", "dof_pos"):
                want = g[key][itr // every]
                worst = max(worst, float(np.abs(snap[key] - want).max())
                            / max(float(np.abs(want).max()), 1.0))
        small.step(itr)
    log(f"{name}: {n} envs vs gym_franka_osc_standin.npz (hand_pos, dof_pos every {every} "
        f"steps): max |err| of largest magnitude {worst:.3e}")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"{name} departs from the golden: {worst:.3e} > {GOLDEN_TOL}")


def gym_interop_phase(kernels) -> None:
    """examples/interop_torch.py's scene at GYM_CAMERA_ENVS envs (a ball and a
    128 x 128 camera with enable_tensors in each): the build's seconds,
    GYM_CAMERA_FRAMES frames of simulate + render_all_camera_sensors +
    start/end_access_image_tensors + get_camera_image_gpu_tensor with the
    kernels' counts read around them (none); the image tensors on the card,
    their data_address their data_ptr, aliasing the sensor's image across
    frames; a second run from the same roots bitwise equal; env 0's frame
    against gym_interop_standin.npz; a step with host syncs made errors."""
    from test_isaacgym_tpu_torch import gymapi, gymtorch
    from test_isaacgym_tpu_torch.envs import gym_scenes

    name = f"gym_interop{GYM_CAMERA_ENVS}"
    t = time.perf_counter()
    gym, sim, envs, cams = gym_scenes.interop(gymapi, GYM_CAMERA_ENVS, {"device": DEV})
    gym.prepare_sim(sim)
    root = gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim))
    root0 = root.clone()
    torch.cuda.synchronize()
    log(f"{name}: {GYM_CAMERA_ENVS} envs with a {gym_scenes.CAMERA_SIZE}^2 camera each built "
        f"in {time.perf_counter() - t:.2f} s")

    def frame():
        return gym_scenes.interop_frame(gym, gymapi, gymtorch, sim, envs[0], cams[0])

    def run():
        gym.set_actor_root_state_tensor(sim, root0)
        ptrs = set()
        for _ in range(GYM_CAMERA_FRAMES):
            img = frame()
            h = gym.get_camera_image_gpu_tensor(sim, envs[0], cams[0], gymapi.IMAGE_COLOR)
            if h.data_address != img.data_ptr() or img.device.type != torch.device(DEV).type:
                raise RuntimeError(f"{name}: the image tensor is not the handle's, on the card")
            ptrs.add(img.data_ptr())
        if len(ptrs) != 1:
            raise RuntimeError(f"{name}: the image tensor moved between frames")
        sensor = sim.cameras[cams[0]]
        return img, [x.clone() for x in (sensor.color, sensor.depth, sensor.segmentation)]

    frame()  # warm
    torch.cuda.reset_peak_memory_stats()
    (img, a), step_ms, launches = timed(run, kernels, name, GYM_CAMERA_FRAMES, GYM_CAMERA_ENVS,
                                        "env")
    no_kernel_launches(kernels, name)
    log(f"{name}: {step_ms:.4f} ms/frame (physics, render of {GYM_CAMERA_ENVS * 128 * 128} rays, "
        f"the image tensor), {GYM_CAMERA_ENVS / step_ms * 1e3:.1f} env-frames/s, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"image tensor {tuple(img.shape)} {img.dtype} on {img.device}")
    _, b = run()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError(f"{name}: two runs from the same roots differ")
    log(f"{name}: two runs of {GYM_CAMERA_FRAMES} frames are bitwise equal (colour, depth and "
        f"segmentation of all {GYM_CAMERA_ENVS} envs)")
    g = np.load(port_data("gym_interop_standin.npz"))
    frame_check(f"{name} env 0 after {int(g['frames'])} frames", a[0][0], a[2][0], g["rgb"],
                g["seg"])
    log(f"{name}: {count_ops(frame)} non-view PyTorch ops a frame")
    assert_sync_free(lambda: (gym.simulate(sim), gym.refresh_actor_root_state_tensor(sim),
                              gym.set_actor_root_state_tensor(sim, root)), name)
    profile_steps(lambda _: [frame() for _ in range(5)], None, step_ms, 5, "frame")


def free_port() -> int:
    """A free TCP port on this host for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_checks(kernels, envs_per_rank=SHARD_ENVS, steps=SHARD_STEPS,
                   worlds_per_rank=SHARD_WORLDS, ball_steps=SHARD_BALL_STEPS) -> None:
    """The sharded paths on the process group this rank joined (one rank a
    card): the full Franka OSC step through rollout_with_obs (obs dof_pos)
    at envs_per_rank envs a rank with the kernels' counts read around it
    (none), its env-steps/s per rank and in aggregate, the gather's share of
    a step (rollout_with_obs against shard_step over the same steps, in
    turns, and the gather alone), the gathered obs against the native
    FrankaOscEnv rollout of all the envs on rank 0 (and rank 0 alone at
    envs_per_rank envs); then BallsEnv at worlds_per_rank worlds a rank
    through the sphere-world kernel (exactly 2 launches a solve), the final
    positions gathered and held to the unsharded run, the contact force
    summed over ranks by psum_metrics. Raises on any mismatch."""
    import torch.distributed as dist

    from test_isaacgym_tpu_torch.envs.balls import BallsEnv
    from test_isaacgym_tpu_torch.envs.franka import FrankaOscEnv
    from test_isaacgym_tpu_torch.ops.sphere_world import LAUNCHES_PER_SOLVE
    from test_isaacgym_tpu_torch.parallel import mesh as pm

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = pm.make_env_mesh()
    n = envs_per_rank * world
    name = f"sharded_franka{world}x{envs_per_rank}"
    t = time.perf_counter()
    env = FrankaOscEnv(num_envs=n, device=DEV)
    sim = env.sim
    st, ac, pa = (pm.shard_env_tree(x, mesh, n) for x in (sim.state, sim.actions, sim.params))
    refs = pm.shard_env_tree((env.init_hand_pos, env.init_hand_quat, env.origins), mesh, n)
    log(f"{name} rank {rank}: {n} envs built, {envs_per_rank} kept, on {st.dof_pos.device} "
        f"({dist.get_backend()}) in {time.perf_counter() - t:.2f} s")

    def step_fn(s, a, p):
        return env._step_impl(s, a, p, s.steps, refs)

    def obs_fn(s):
        return s.dof_pos

    run = pm.rollout_with_obs(step_fn, obs_fn, mesh, st, ac, pa, steps)
    step = pm.shard_step(step_fn, mesh, st, ac, pa)

    def plain():
        s = st
        for _ in range(steps):
            s = step(s, ac, pa)
        return s

    pm.rollout_with_obs(step_fn, obs_fn, mesh, st, ac, pa, 2)(st, ac, pa)  # warm
    dist.barrier()
    (final, obs), ms_gather, launches = timed(lambda: run(st, ac, pa), kernels, name, steps,
                                              envs_per_rank, "env")
    if any(launches.values()):
        raise RuntimeError(f"{name} launched hand-written kernels: {launches}")
    if tuple(obs.shape) != (steps, n, 9) or not torch.isfinite(obs).all():
        raise RuntimeError(f"{name}: gathered obs {tuple(obs.shape)} not finite or not (steps, N, 9)")
    assert_finite(final, name)
    turns = {"plain": [], "gather": [ms_gather]}
    for which, fn in (("plain", plain), ("gather", lambda: run(st, ac, pa)), ("plain", plain)):
        dist.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        turns[which].append((time.perf_counter() - t) / steps * 1e3)
    ms_plain, ms_gather = (float(np.mean(turns[k])) for k in ("plain", "gather"))
    local = obs_fn(final)
    gather = lambda: pm.gather_obs(local, mesh=mesh)  # noqa: E731
    gather()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(50):
        gather()
    torch.cuda.synchronize()
    ms_one = (time.perf_counter() - t) / 50 * 1e3
    worst = torch.tensor([ms_gather, ms_plain], dtype=torch.float64, device=local.device)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    log(f"{name} rank {rank}: {ms_gather:.4f} ms/step with the gather ({turns['gather']}), "
        f"{ms_plain:.4f} without ({turns['plain']}): {envs_per_rank / ms_gather * 1e3:.1f} "
        f"env-steps/s a rank; the gather's share of a step {1 - ms_plain / ms_gather:+.4f} "
        f"(difference of the runs), {ms_one:.4f} ms a gather of {tuple(local.shape)} alone "
        f"= {ms_one / ms_gather:.4%} of a step")
    if rank == 0:
        log(f"{name}: {world} ranks x {envs_per_rank} envs: {n / float(worst[0]) * 1e3:.1f} "
            f"env-steps/s in aggregate with the gather (slowest rank {float(worst[0]):.4f} "
            f"ms/step), {n / float(worst[1]) * 1e3:.1f} without")
        native = env.rollout_fn(1)
        s, want = sim.state, []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            s = native(s)
            want.append(s.dof_pos)
        torch.cuda.synchronize()
        ms_native = (time.perf_counter() - t) / steps * 1e3
        want = torch.stack(want)
        err = float((obs - want).abs().max()) / max(float(want.abs().max()), 1.0)
        log(f"{name}: gathered obs vs the native FrankaOscEnv rollout of {n} envs over {steps} "
            f"steps: bitwise {torch.equal(obs, want)}, max |err| of largest magnitude {err:.3e}; "
            f"the native {n} envs {ms_native:.4f} ms/step ({n / ms_native * 1e3:.1f} env-steps/s)")
        if err > GOLDEN_TOL:
            raise RuntimeError(f"{name}: gathered obs depart from the native rollout: {err:.3e}")
        if world > 1:
            alone = FrankaOscEnv(num_envs=envs_per_rank, device=DEV)
            one = alone.rollout_fn(steps)
            one(alone.rollout_fn(2)(alone.sim.state))
            torch.cuda.synchronize()
            t = time.perf_counter()
            one(alone.sim.state)
            torch.cuda.synchronize()
            ms_alone = (time.perf_counter() - t) / steps * 1e3
            log(f"{name}: one rank alone at {envs_per_rank} envs {ms_alone:.4f} ms/step "
                f"({envs_per_rank / ms_alone * 1e3:.1f} env-steps/s); {world} ranks in aggregate "
                f"{(n / float(worst[0])) / (envs_per_rank / ms_alone):.3f}x it")
            del alone, one
    del env, sim, st, ac, pa, refs, final, obs
    dist.barrier()

    name = f"sharded_balls{world}x{worlds_per_rank}"
    nw = worlds_per_rank * world
    benv = BallsEnv(num_worlds=nw, device=DEV)
    bsim = benv.sim
    bs, ba, bp = (pm.shard_env_tree(x, mesh, nw) for x in (bsim.state, bsim.actions, bsim.params))
    brun = pm.shard_step(lambda s, a, p: bsim.stepper.rollout(s, a, p, ball_steps), mesh, bs, ba, bp)
    dist.barrier()
    out, _, launches = timed(lambda: brun(bs, ba, bp), kernels, name, ball_steps,
                             worlds_per_rank * benv.balls_per_world, "ball")
    want_launches = ball_steps * LAUNCHES_PER_SOLVE
    if launches.get("sphere_world", 0) != want_launches:
        raise RuntimeError(f"{name} rank {rank} launched the kernel {launches} times, "
                           f"want {want_launches}")
    assert_finite(out, name)
    pos = pm.gather_obs(out.root_pos, mesh=mesh)
    force = pm.psum_metrics(out.contact_force.sum((0, 1)), mesh)
    log(f"{name} rank {rank}: {launches['sphere_world']} sphere_world launches in {ball_steps} "
        f"steps of {worlds_per_rank} worlds")
    if rank == 0:
        ref = benv.rollout_fn(ball_steps)(bsim.state)
        _, rel = max_rel_err([ref.root_pos], [pos])
        want_f = ref.contact_force.sum((0, 1))
        f_err = float((force - want_f).abs().max()) / max(float(want_f.abs().max()), 1.0)
        log(f"{name}: {nw} worlds over {world} ranks vs one process: positions bitwise "
            f"{torch.equal(pos, ref.root_pos)}, max |err| of largest magnitude {rel:.3e}; summed "
            f"contact force {force.tolist()} vs {want_f.tolist()} ({f_err:.3e})")
        if rel > SOLVE_TOL or f_err > SOLVE_TOL:
            raise RuntimeError(f"{name}: the sharded balls depart from the unsharded run")
        if not float(force[2]) > 0:
            raise RuntimeError(f"{name}: no ground contact after {ball_steps} steps")
    dist.barrier()


def sharded_phase(kernels) -> None:
    """sharded_checks at world size 1, in this process: NCCL on the card
    through init_distributed on a free localhost port."""
    import datetime

    import torch.distributed as dist

    from test_isaacgym_tpu_torch.parallel import mesh as pm

    pm.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=DEV,
                        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
    try:
        sharded_checks(kernels)
    finally:
        dist.destroy_process_group()


def phase_timed(fn, *args):
    """fn(*args), its wall seconds logged (the script's time limit is
    shared by every phase)."""
    t = time.perf_counter()
    out = fn(*args)
    log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv
    from test_isaacgym_tpu_torch.ops import _kernels
    from test_isaacgym_tpu_torch.ops import sphere_world as sw

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- 1. build every kernel of the path from this checkout's sources ----
    t = time.perf_counter()
    path = _kernels.build("sphere_world")
    log(f"build: sphere_world {time.perf_counter() - t:.2f} s -> {os.path.basename(path)}")
    for line in _kernels.build_logs.get("sphere_world", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # ---- 2. kernel vs plain: random worlds, the piled 1080-ball world, the
    # dense cube; bitwise repeatability; the piled world's times ----
    for N in (1, 2):
        rargs = [random_spec(sw, 96, dev), *random_solve_args(3, N, 96, dev),
                 1 / 120, 8, 0.01, 0.0025, 0.2]
        _kernels.launches.clear()
        check_solve(sw, rargs, f"random F=96 N={N}")
        per_solve = _kernels.launches["sphere_world"]
    log(f"sphere_world launches per solve: {per_solve}")
    if not 1 <= per_solve <= 2:
        raise RuntimeError(f"sphere_world made {per_solve} launches in a solve, want 1 or 2")
    check_repeatable(sw, rargs, "random F=96 N=2")
    dense = [random_spec(sw, 1080, dev), *(torch.as_tensor(a, device=dev) for a in dense_cube()),
             1 / 60, 9, 0.01, 0.0025, 0.2]
    check_solve(sw, dense, "dense cube F=1080")
    check_repeatable(sw, dense, "dense cube F=1080")
    log(f"dense cube F=1080: {sphere_world_bound(dense)[2]} active pairs, "
        f"kernel {graph_ms(lambda: sw.solve(*dense), reps=20):.4f} ms/solve")
    pile = BallsEnv(pyramids=36, device="cuda")
    sim = pile.sim
    state = pile.rollout_fn(PILE_STEPS)(sim.state)
    st = sim.stepper
    fd = st.free_velocities(state, sim.actions, sim.params)
    args = st.contact._sphere_world_inputs(
        state.body_pos, fd["v"], fd["w"], fd["m"], fd["I_w"], sim.params, st.h
    )
    F = args[1].shape[1]
    err_1080 = check_solve(sw, args, f"balls F={F} after {PILE_STEPS} steps")
    check_repeatable(sw, args, f"balls F={F}")
    bound_ms, bound_by, active = sphere_world_bound(args)
    kernel_ms = graph_ms(lambda: sw.solve(*args), reps=200)
    log(f"  back-to-back calls (host launch overhead included; the method of "
        f"the ms before the kernel's redesign): "
        f"{time_ms(lambda: sw.solve(*args), reps=50):.4f} ms/solve")
    plain_ms = time_ms(lambda: sw._torch_solve(*args), reps=5, warmup=1)
    log(f"sphere_world F={F}: {active} active pairs, kernel {kernel_ms:.4f} ms/solve, "
        f"plain {plain_ms:.4f} ms/solve, bound {bound_ms:.6f} ms ({bound_by})")
    log(f"  device scratch: {sw.scratch_layout(1, F, args[0].entries)[3]} bytes a world "
        f"(two dense (F, F) f32 impulse matrices: {8 * F * F})")
    launch_shares(lambda: sw.solve(*args))
    # one sweep's cost: the slope of ms/solve over the number of sweeps
    t1, t17 = (graph_ms(lambda: sw.solve(*args[:10], n, *args[11:]), reps=200) for n in (1, 17))
    log(f"  per sweep: {(t17 - t1) / 16 * 1e3:.3f} us (1 sweep {t1:.4f} ms, 17 sweeps {t17:.4f} ms)")

    # ---- 3. the main path: 1080 balls, STEPS steps, counts around it only ----
    env = BallsEnv(pyramids=36, device="cuda")
    run = env.rollout_fn(STEPS)
    s, step_ms, launches = timed(lambda: run(env.sim.state), _kernels, "balls", STEPS,
                                 env.balls_per_world, "ball")
    if launches.get("sphere_world", 0) != STEPS * per_solve:
        raise RuntimeError(f"sphere_world launched {launches} times, want {STEPS * per_solve}")
    assert_finite(s, "balls")
    z = s.root_pos[0, :, 2]
    zmin, zmax = float(z.min()), float(z.max())
    fz = float(s.contact_force[0, :, 2].max())
    log(f"end state: zmin {zmin:.4f} zmax {zmax:.4f} max ground force {fz:.4f}")
    if not (zmin > 0.15 and zmax < 3.0 and fz > 0):
        raise RuntimeError("the 1080-ball world sank, exploded or lost ground support")

    profile_steps(env.rollout_fn(PROFILE_STEPS), s, step_ms)

    # ---- 4. right answers: the 120-ball drop against the committed golden ----
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "goldens", "balls_drop.npz"))["pos"]
    small = BallsEnv(pyramids=4, device="cuda")
    worst = golden_err({"pos": golden}, small.sim.state, lambda s: {"pos": s.root_pos[0]},
                       small.rollout_fn(10))
    log(f"120-ball drop vs golden: max |err| of largest magnitude {worst:.3e}")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"120-ball drop departs from the golden: {worst:.3e} > {GOLDEN_TOL}")

    log(f"phase kernel checks, balls and the 120-ball drop: {time.perf_counter() - t_start:.1f} s")

    # ---- 5. the flagship Franka OSC path, with its own counts ----
    phase_timed(franka_phase, _kernels)

    # ---- 6. the franka_cube pick path (the contact table), with its own counts ----
    phase_timed(cube_phase, _kernels)

    # ---- 7. attractors, the UAV-car pursuit, the neighbor-list worlds (the
    # mixed one beside the sphere-world kernel), each with its own counts,
    # and the TIG_DEBUG checks ----
    phase_timed(attractor_phase, _kernels)
    phase_timed(uav_phase, _kernels)
    phase_timed(box_phase, _kernels)
    err_mixed = phase_timed(mixed_phase, _kernels, sw)
    log(f"sphere_world vs plain on the mixed world: max |err| {err_mixed:.3e}")
    phase_timed(debug_phase)

    # ---- 8. convex hulls and terrain: kuka_bin.py's objects on a ground
    # and over the AnymalTerrain map (no kernel), and the 1080 balls over a
    # bowl (the kernel without ground), each with its own counts ----
    from test_isaacgym_tpu_torch.envs import pile

    phase_timed(pile_phase, _kernels, "hull_pile4096")
    t = time.perf_counter()
    terrain = pile.anymal_terrain()
    log(f"terrain map {terrain[0].shape} made in {time.perf_counter() - t:.2f} s")
    phase_timed(pile_phase, _kernels, "terrain4096", terrain)
    err_terrain = phase_timed(balls_terrain_phase, _kernels, sw)
    log(f"sphere_world vs plain on the balls over terrain: max |err| {err_terrain:.3e}")

    # ---- 9. SDF contact: the nut spun down the bolt, and the arm-driven
    # screw FSM, each with its own counts ----
    phase_timed(nut_bolt_phase, _kernels)
    phase_timed(franka_nut_bolt_phase, _kernels)

    # ---- 10. soft bodies: the XPBD tet solve of examples/soft_body.py,
    # with its own counts ----
    phase_timed(soft_body_phase, _kernels)

    # ---- 11. the RL vec-envs and the renderer: the Ant and the Franka
    # reach through make(), each with its own counts; bench.py's render
    # config; a camera on every Ant env ----
    phase_timed(ant_phase, _kernels)
    phase_timed(reach_phase, _kernels)
    phase_timed(render_phase, _kernels)
    phase_timed(camera_phase, _kernels)

    # ---- 12. the gymapi facade as the reference's scripts drive it: the
    # 1080 balls through gym calls (the kernel), franka_osc.py's loop, and
    # interop_torch.py's camera tensors, each with its own counts ----
    phase_timed(gym_balls_phase, _kernels)
    phase_timed(gym_franka_osc_phase, _kernels)
    phase_timed(gym_interop_phase, _kernels)

    # ---- 13. env-axis sharding: the Franka OSC and balls paths through
    # parallel/mesh.py at world size 1 over NCCL, each with its own counts ----
    phase_timed(sharded_phase, _kernels)

    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    log("sphere_world launches by main path: "
        + ", ".join(f"{k} {v}" for k, v in PATH_LAUNCHES.items()))
    log(json.dumps({"kernels": [{
        "name": "sphere_world",
        "route": "cuda",
        "source": "test_isaacgym_tpu_torch/csrc/sphere_world.cu",
        "replaces": "test_isaacgym_tpu/ops/sphere_world.py:334",
        "launches": launches["sphere_world"] + PATH_LAUNCHES[f"sharded_balls1x{SHARD_WORLDS}"],
        "max_abs_err": err_1080,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

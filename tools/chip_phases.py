#!/usr/bin/env python3
"""Run some of chip_smoke.py's check phases of one checkout, on the card.

    python3 tools/chip_phases.py ROOT PHASE [PHASE ...]

ROOT is a checkout of this repository (this one, or an unpacked earlier
commit); PHASE names a phase of ROOT's chip_smoke.py:

    sphere_world   sphere_world_kernel_phase: the kernel against its plain
                   version, its graph-replay time and bound
    balls          balls_phase: the 1080 balls and the 120-ball drop golden
    fk             fk_kernel_phase: the fk kernel at the Franka path's shape
    chol           chol_kernel_phase: the chol kernel at the main paths'
                   shapes, timed at the Franka path's phase-A shape
    franka         franka_phase: the Franka OSC flagship, 4096 envs
    franka_cube    cube_phase: the franka_cube pick path, 4096 envs
    attractor      attractor_phase: examples/franka_attractor.py, 4096 envs
    uav_car        uav_phase: the UAV-car pursuit, 4096 envs
    box            box_phase: the 1080-box neighbor-list world
    mixed          mixed_phase: 100 spheres beside 100 boxes
    debug          debug_phase: the TIG_DEBUG checks
    hull_pile      pile_phase without terrain (4096 envs)
    terrain        pile_phase over the AnymalTerrain map (4096 envs)
    balls_terrain  balls_terrain_phase: the 1080 balls over a bowl
    nut_bolt       nut_bolt_phase: 1024 nuts spun down the bolt
    franka_nut_bolt  franka_nut_bolt_phase: the 512-env screw FSM
    soft_body      soft_body_phase: 1024 envs of the XPBD tet icosphere
    ant            ant_phase: make(task="Ant"), 4096 envs of the Ant stand-in
    franka_reach   reach_phase: make(task="Franka"), 4096 envs
    render         render_phase: bench.py's 1600 x 900 render config
    raycast        raycast_kernel_phase: the raycast kernel on the Ant
                   camera cell's frame and gym_interop's, bit for bit;
                   timed at the Ant camera cell's shape
    ant_camera     camera_phase: a 64 x 48 camera on each of 4096 Ant envs
    gym_balls      gym_balls_phase: the 1080 balls through the gymapi facade
    gym_franka_osc gym_franka_osc_phase: examples/franka_osc.py's loop, 4096 envs
    gym_interop    gym_interop_phase: examples/interop_torch.py, 1024 cameras
    examples       examples_phase: the repository's example scripts
    sharded        sharded_checks on a rank a visible card (NCCL): the full
                   Franka OSC step at 1024 envs a rank for 50 steps through
                   rollout_with_obs against the native rollout of all the
                   envs, and one world of 1080 balls a rank against the
                   unsharded run

`sharded` runs rank 0 in this process and spawns ranks 1.. as
`ROOT sharded_rank` through portbench/harness/ranks.py's `spawn` (one
process a card, RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and
MASTER_ADDR/MASTER_PORT set); a rank that fails, or outlives rank 0 by
ranks.RANK_TIMEOUT, fails the phase.

The kernels are built from ROOT's sources first. Each phase runs its checks
and raises on the first that fails; the script logs each phase's seconds.
"""
import os
import subprocess
import sys
import time

SHARDED_STEPS, SHARDED_WORLDS = 50, 1  # a rank's steps and ball worlds


def terrain(cs, kernels) -> None:
    """pile_phase over the AnymalTerrain map."""
    from test_isaacgym_tpu_torch.envs import pile

    cs.pile_phase(kernels, "terrain4096", pile.anymal_terrain())


def sharded_rank(cs, kernels) -> None:
    """This process's rank of `sharded`, on the process group the
    environment names."""
    import torch.distributed as dist

    from test_isaacgym_tpu_torch.parallel import mesh as pm

    pm.init_distributed()
    try:
        cs.sharded_checks(kernels, steps=SHARDED_STEPS, worlds_per_rank=SHARDED_WORLDS)
    finally:
        dist.destroy_process_group()


def sharded(cs, kernels, root) -> None:
    """Rank 0 here and one spawned rank a further card; raises unless every
    rank passes."""
    import torch

    from portbench.harness import ranks

    world = torch.cuda.device_count()
    cs.log(f"sharded: {world} ranks, one a card")
    procs = ranks.spawn([os.path.abspath(__file__), root, "sharded_rank"], world)
    try:
        sharded_rank(cs, kernels)
    finally:
        codes = ranks.join(procs)
    if any(codes):
        raise SystemExit(f"sharded: ranks 1.. exited {codes}")


def main(root, phases):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch
    from test_isaacgym_tpu_torch.ops import _kernels as k
    from test_isaacgym_tpu_torch.ops import sphere_world as sw

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    table = {
        "sphere_world": lambda: cs.sphere_world_kernel_phase(k),
        "balls": lambda: cs.balls_phase(k),
        "fk": lambda: cs.fk_kernel_phase(k),
        "chol": lambda: cs.chol_kernel_phase(k),
        "franka": lambda: cs.franka_phase(k),
        "franka_cube": lambda: cs.cube_phase(k),
        "attractor": lambda: cs.attractor_phase(k),
        "uav_car": lambda: cs.uav_phase(k),
        "box": lambda: cs.box_phase(k),
        "mixed": lambda: cs.mixed_phase(k, sw),
        "debug": cs.debug_phase,
        "hull_pile": lambda: cs.pile_phase(k, "hull_pile4096"),
        "terrain": lambda: terrain(cs, k),
        "balls_terrain": lambda: cs.balls_terrain_phase(k, sw),
        "nut_bolt": lambda: cs.nut_bolt_phase(k),
        "franka_nut_bolt": lambda: cs.franka_nut_bolt_phase(k),
        "soft_body": lambda: cs.soft_body_phase(k),
        "ant": lambda: cs.ant_phase(k),
        "franka_reach": lambda: cs.reach_phase(k),
        "render": lambda: cs.render_phase(k),
        "raycast": lambda: cs.raycast_kernel_phase(k),
        "ant_camera": lambda: cs.camera_phase(k),
        "gym_balls": lambda: cs.gym_balls_phase(k),
        "gym_franka_osc": lambda: cs.gym_franka_osc_phase(k),
        "gym_interop": lambda: cs.gym_interop_phase(k),
        "examples": cs.examples_phase,
        "sharded": lambda: sharded(cs, k, root),
        "sharded_rank": lambda: sharded_rank(cs, k),
    }
    unknown = [name for name in phases if name not in table]
    if unknown:
        raise SystemExit(f"unknown phases {unknown}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.card_line())
    cs.log(f"tree {root} at {subprocess.run(['git', '-C', root, 'log', '-1', '--format=%h'], capture_output=True, text=True).stdout.strip() or 'an unpacked archive'}")
    t = time.perf_counter()
    k.build("sphere_world")
    cs.log(f"build: sphere_world {time.perf_counter() - t:.2f} s")
    for name in phases:
        t = time.perf_counter()
        table[name]()
        cs.log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2:]))

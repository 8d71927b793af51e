#!/usr/bin/env python3
"""Run some of chip_smoke.py's phases of one checkout, on the card.

    python3 tools/chip_phases.py ROOT PHASE [PHASE ...]

ROOT is a checkout of this repository (this one, or an unpacked earlier
commit); PHASE is the name of a phase function of ROOT's chip_smoke.py that
takes the kernel module (box_phase, pile_phase hull, ...):

    box            box_phase: the 1080-box neighbor-list world
    mixed          mixed_phase: 100 spheres beside 100 boxes
    hull_pile      pile_phase without terrain (4096 envs)
    terrain        pile_phase over the AnymalTerrain map (4096 envs)
    balls_terrain  balls_terrain_phase: the 1080 balls over a bowl
    nut_bolt       nut_bolt_phase: 1024 nuts spun down the bolt
    franka_nut_bolt  franka_nut_bolt_phase: the 512-env screw FSM
    soft_body      soft_body_phase: 1024 envs of the XPBD tet icosphere
    ant            ant_phase: make(task="Ant"), 4096 envs of the Ant stand-in
    franka_reach   reach_phase: make(task="Franka"), 4096 envs
    render         render_phase: bench.py's 1600 x 900 render config
    ant_camera     camera_phase: a 64 x 48 camera on each of 4096 Ant envs
    gym_balls      gym_balls_phase: the 1080 balls through the gymapi facade
    gym_franka_osc gym_franka_osc_phase: examples/franka_osc.py's loop, 4096 envs
    gym_interop    gym_interop_phase: examples/interop_torch.py, 1024 cameras
    sharded        sharded_checks on a rank a visible card (NCCL): the full
                   Franka OSC step at 1024 envs a rank for 50 steps through
                   rollout_with_obs against the native rollout of all the
                   envs and one rank alone, and one world of 1080 balls a
                   rank against the unsharded run

`sharded` spawns this script once a card as `ROOT sharded_rank`, with
RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and MASTER_ADDR/MASTER_PORT
set; a rank that fails or hangs past RANK_TIMEOUT fails the phase.

The kernels are built from ROOT's sources first. Each phase prints what it
prints in chip_smoke.py (ms/step, rates, busy share, ops a step, its
checks). Two trees compared in one call on one card, as parent, change,
change, parent, give versions of a path measured on the same host.
"""
import os
import subprocess
import sys
import time

SHARDED_STEPS, SHARDED_WORLDS = 50, 1  # a rank's steps and ball worlds
RANK_TIMEOUT = 600  # seconds the ranks of `sharded` may take in all


def spawn_ranks(root, world):
    """Run `ROOT sharded_rank` in `world` processes, a card each; raise
    unless every rank exits 0 within RANK_TIMEOUT."""
    import chip_smoke as cs

    port = cs.free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), root, "sharded_rank"], env=env))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        raise SystemExit(f"sharded: a rank ran past {RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise SystemExit(f"sharded: ranks exited {codes}")


def main(root, phases):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch
    from test_isaacgym_tpu_torch.ops import _kernels
    from test_isaacgym_tpu_torch.ops import sphere_world as sw

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(cs.card_line())
    cs.log(f"tree {root} at {subprocess.run(['git', '-C', root, 'log', '-1', '--format=%h'], capture_output=True, text=True).stdout.strip() or 'an unpacked archive'}")
    t = time.perf_counter()
    _kernels.build("sphere_world")
    cs.log(f"build: sphere_world {time.perf_counter() - t:.2f} s")
    for name in phases:
        t = time.perf_counter()
        if name == "box":
            cs.box_phase(_kernels)
        elif name == "mixed":
            cs.mixed_phase(_kernels, sw)
        elif name == "hull_pile":
            cs.pile_phase(_kernels, "hull_pile4096")
        elif name == "terrain":
            from test_isaacgym_tpu_torch.envs import pile

            cs.pile_phase(_kernels, "terrain4096", pile.anymal_terrain())
        elif name == "balls_terrain":
            cs.balls_terrain_phase(_kernels, sw)
        elif name == "nut_bolt":
            cs.nut_bolt_phase(_kernels)
        elif name == "franka_nut_bolt":
            cs.franka_nut_bolt_phase(_kernels)
        elif name == "soft_body":
            cs.soft_body_phase(_kernels)
        elif name == "ant":
            cs.ant_phase(_kernels)
        elif name == "franka_reach":
            cs.reach_phase(_kernels)
        elif name == "render":
            cs.render_phase(_kernels)
        elif name == "ant_camera":
            cs.camera_phase(_kernels)
        elif name == "gym_balls":
            cs.gym_balls_phase(_kernels)
        elif name == "gym_franka_osc":
            cs.gym_franka_osc_phase(_kernels)
        elif name == "gym_interop":
            cs.gym_interop_phase(_kernels)
        elif name == "sharded":
            world = torch.cuda.device_count()
            cs.log(f"sharded: {world} ranks, one a card")
            spawn_ranks(root, world)
        elif name == "sharded_rank":
            import torch.distributed as dist

            from test_isaacgym_tpu_torch.parallel import mesh as pm

            pm.init_distributed()
            try:
                cs.sharded_checks(_kernels, steps=SHARDED_STEPS, worlds_per_rank=SHARDED_WORLDS)
            finally:
                dist.destroy_process_group()
        else:
            raise SystemExit(f"unknown phase {name!r}")
        cs.log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2:]))

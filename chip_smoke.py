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
last the TIG_DEBUG checks (a planted NaN raises, verify_step_purity on the
balls, Franka OSC and franka_cube steps). It prints:
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
# the device of every phase's envs ("cpu" only in a rehearsal of the phases on the CPU)
DEV = "cuda"


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


def profile_steps(run_steps, state, step_ms, steps=PROFILE_STEPS):
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
        log(f"profile {steps} steps: device time not measured (no device events)")
        return
    busy_us = sum(d[2] for d in dev) / steps
    log(f"profile {steps} steps: device busy {busy_us:.1f} us/step, "
        f"{100 * busy_us / (step_ms * 1e3):.1f}% of the {step_ms:.4f} ms step; "
        f"{sum(d[1] for d in dev) / steps:.1f} device launches/step")
    for key, count, us in dev[:6]:
        log(f"  {us / steps:8.1f} us/step {count / steps:5.1f}x/step  {key[:90]}")
    sw = [d for d in dev if "sw_broadphase" in d[0] or "sw_sweeps" in d[0]]
    log(f"  sphere_world kernels: {sum(d[2] for d in sw) / steps:.1f} us/step, "
        f"{sum(d[1] for d in sw) / steps:.1f} launches/step")


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
            lambda: env._control(state, state.steps, params),
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
    """Ops and host ms (time_layers) of the layers of a franka_cube
    step: the control, and of a substep phase A (body cache reused, then
    with FK), phase B, phase C's inputs (current poses, link Jacobians,
    A^-1), narrowphase, the solve's set-up (narrowphase included), one
    Jacobi sweep (a substep runs `iters` of them, then a few ops of
    read-back and contact force), phase D; and the refresh."""
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
        "control (FSM, jacobian, mass matrix, OSC solves)": lambda: env.control(ps),
        "phase A, body cache reused": lambda: stp.group_velocities(state, actions, params, True),
        "phase A with FK": lambda: stp.group_velocities(state, actions, params, False),
        "phase B (the cube)": lambda: stp.free_velocities(state, actions, params),
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
    from the same state (the solve's scatter-adds use atomics), a profile
    and the solve's device time."""
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
        f"{diff:.3e} (the solve's scatter-adds use atomics, whose order may vary)")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv
    from test_isaacgym_tpu_torch.ops import _kernels
    from test_isaacgym_tpu_torch.ops import sphere_world as sw

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

    # ---- 5. the flagship Franka OSC path, with its own counts ----
    franka_phase(_kernels)

    # ---- 6. the franka_cube pick path (the contact table), with its own counts ----
    cube_phase(_kernels)

    # ---- 7. attractors, the UAV-car pursuit, the neighbor-list worlds (the
    # mixed one beside the sphere-world kernel), each with its own counts,
    # and the TIG_DEBUG checks ----
    attractor_phase(_kernels)
    uav_phase(_kernels)
    box_phase(_kernels)
    err_mixed = mixed_phase(_kernels, sw)
    log(f"sphere_world vs plain on the mixed world: max |err| {err_mixed:.3e}")
    debug_phase()

    log(json.dumps({"kernels": [{
        "name": "sphere_world",
        "route": "cuda",
        "source": "test_isaacgym_tpu_torch/csrc/sphere_world.cu",
        "replaces": "test_isaacgym_tpu/ops/sphere_world.py:334",
        "launches": launches["sphere_world"],
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

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
against tests/goldens/balls_drop.npz, and prints:
  * the card's name and power limit (nvidia-smi);
  * per-phase numbers (build seconds, kernel and plain times, each launch's
    share of a solve and one sweep's cost, ball-steps/s, device busy share
    and the kernels that take the most device time). A kernel's time is its
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
GOLDEN_TOL = 1e-4  # 120-ball drop on the card vs tests/goldens/balls_drop.npz (its own rule)


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


def profile_steps(run_steps, state, step_ms):
    """Where a step's time goes: torch.profiler over PROFILE_STEPS steps of
    the main path. Prints device busy time per step (device-side events
    only: kernels, copies, sets), its share of the unprofiled step time
    `step_ms`, device launches per step and the kernels that take the most
    device time."""
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
        log(f"profile {PROFILE_STEPS} steps: device time not measured (no device events)")
        return
    busy_us = sum(d[2] for d in dev) / PROFILE_STEPS
    log(f"profile {PROFILE_STEPS} steps: device busy {busy_us:.1f} us/step, "
        f"{100 * busy_us / (step_ms * 1e3):.1f}% of the {step_ms:.4f} ms step; "
        f"{sum(d[1] for d in dev) / PROFILE_STEPS:.1f} device launches/step")
    for key, count, us in dev[:6]:
        log(f"  {us / PROFILE_STEPS:8.1f} us/step {count / PROFILE_STEPS:5.1f}x/step  {key[:90]}")
    sw = [d for d in dev if "sw_broadphase" in d[0] or "sw_sweeps" in d[0]]
    log(f"  sphere_world kernels: {sum(d[2] for d in sw) / PROFILE_STEPS:.1f} us/step, "
        f"{sum(d[1] for d in sw) / PROFILE_STEPS:.1f} launches/step")


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
    torch.cuda.synchronize()
    _kernels.launches.clear()
    t = time.perf_counter()
    s = run(env.sim.state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(_kernels.launches)
    n_balls = env.balls_per_world
    log(f"main path: {STEPS} steps of {n_balls} balls in {wall:.3f} s: "
        f"{n_balls * STEPS / wall:.1f} ball-steps/s, {wall / STEPS * 1e3:.4f} ms/step, "
        f"launches {launches}")
    if launches.get("sphere_world", 0) != STEPS * per_solve:
        raise RuntimeError(f"sphere_world launched {launches} times, want {STEPS * per_solve}")
    for name, v in s._asdict().items():
        if v is not None and v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"state.{name} is not finite")
    z = s.root_pos[0, :, 2]
    zmin, zmax = float(z.min()), float(z.max())
    fz = float(s.contact_force[0, :, 2].max())
    log(f"end state: zmin {zmin:.4f} zmax {zmax:.4f} max ground force {fz:.4f}")
    if not (zmin > 0.15 and zmax < 3.0 and fz > 0):
        raise RuntimeError("the 1080-ball world sank, exploded or lost ground support")

    profile_steps(env.rollout_fn(PROFILE_STEPS), s, wall / STEPS * 1e3)

    # ---- 4. right answers: the 120-ball drop against the committed golden ----
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "goldens", "balls_drop.npz"))["pos"]
    small = BallsEnv(pyramids=4, device="cuda")
    s, worst = small.sim.state, 0.0
    step10 = small.rollout_fn(10)
    for k in range(golden.shape[0]):
        want = golden[k]
        err = float(np.abs(s.root_pos[0].cpu().numpy() - want).max())
        worst = max(worst, err / max(float(np.abs(want).max()), 1.0))
        if k + 1 < golden.shape[0]:
            s = step10(s)
    log(f"120-ball drop vs golden: max |err| of largest magnitude {worst:.3e}")
    if worst > GOLDEN_TOL:
        raise RuntimeError(f"120-ball drop departs from the golden: {worst:.3e} > {GOLDEN_TOL}")

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

#!/usr/bin/env python3
"""Remake the goldens of the RL vec-envs and the renderer with the JAX package.

    PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_use_fusion_emitters=false \\
        python tools/make_rl_goldens.py [ant] [ant_big] [franka] [render]

With no argument it makes all four parts. Each part writes into its file
under test_isaacgym_tpu_torch/assets/data/ (an existing file keeps the keys
of the parts not remade):

  ant      ant_standin.npz: the JAX AntVecEnv (test_isaacgym_tpu/envs/
           rl_env.py) on the committed Ant stand-in, 4 envs, actions
           uniform in [-1, 1] from RandomState(0). Its step jitted and op by
           op (jax.disable_jit) until the two part at 1e-4 * max(|ref|, 1)
           on the observation or on the reward, each at its own scale, or
           in `done` (`parted` is that step). The golden ends before the
           first step where they differ by more than half that (`horizon`
           steps): a third rounding path, the port on the card, may differ
           from the jitted run by ~2x what the op-by-op run does. It holds
           the jitted run's obs, reward and done of those steps (`obs[k]`
           after step k + 1), `agree` (the two runs' relative obs and reward
           differences to `parted`), the actions, `frame`, the 320 x
           240 render() of env 0 after the last of those steps, and
           `frame_seg`, that camera's segmentation with each shape's index
           + 1 as its id.
  ant_big  the same file's 4096-env statistics: 200 steps of RandomState(0)
           actions, jitted and op by op; for each run the share of envs
           that reset at some step, the share that left the scene (their
           torso thrown past 10 m or not finite: the JAX env's 30 N m on
           the Ant's light links throws ~7% of them by step 200), and the
           mean torso height of the others after the last step
           (`big_reset_jit`, `big_left_jit`, `big_height_jit`,
           `..._opbyop`). ~25 min, most of it the op-by-op run.
  franka   franka_reach_standin.npz: the JAX FrankaReachVecEnv on the Panda
           stand-in, 8 envs, 60 steps of RandomState(0) actions, obs and
           reward every 10 steps (obs[0] is reset()'s).
  render   render_standin.npz: one env of the JAX FrankaNutBoltEnv's scene
           on the port's stand-ins (the boxes Panda, the code-built nut),
           rendered at 160 x 90 from bench.py's render camera (eye (1.6,
           0.9, 0.9), target (0, 0, 0.4); chip_smoke.nut_scene_render):
           rgba, depth, and seg with each shape's index + 1 as its id.

The JAX package's contact solve unrolls its Jacobi loop; its scans are
traced rolled here (the same iterations, compiled once).
"""
import contextlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "test_isaacgym_tpu_torch", "assets", "data")
ANT, FRANKA, RENDER = (os.path.join(DATA, f) for f in (
    "ant_standin.npz", "franka_reach_standin.npz", "render_standin.npz"))
TOL = 1e-4
ANT_ENVS, ANT_MAX_STEPS = 4, 200
BIG_ENVS, BIG_STEPS = 4096, 200
FRANKA_ENVS, FRANKA_STEPS, FRANKA_EVERY = 8, 60, 10


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def rolled_scan():
    import jax

    scan = jax.lax.scan

    def rolled(f, init, xs=None, length=None, reverse=False, unroll=1, **kw):
        return scan(f, init, xs, length=length, reverse=reverse, unroll=1, **kw)

    jax.lax.scan = rolled
    try:
        yield
    finally:
        jax.lax.scan = scan


def actions(steps, envs, dofs):
    return np.random.RandomState(0).uniform(-1, 1, (steps, envs, dofs)).astype(np.float32)


def jax_ant(num_envs):
    import test_isaacgym_tpu.envs.rl_env as jrl
    from test_isaacgym_tpu_torch.envs import rl_env as trl

    saved, jrl.ASSET_ROOT = jrl.ASSET_ROOT, trl.ASSET_ROOT
    try:
        return jrl.AntVecEnv(num_envs=num_envs)
    finally:
        jrl.ASSET_ROOT = saved


@contextlib.contextmanager
def jax_franka_standin():
    """The JAX FrankaOscEnv (which FrankaReachVecEnv builds) on the Panda
    stand-in."""
    import functools

    import test_isaacgym_tpu.envs.franka as jf
    from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT

    saved = jf.FrankaOscEnv
    jf.FrankaOscEnv = functools.partial(saved, asset_root=STANDIN_ROOT)
    try:
        yield
    finally:
        jf.FrankaOscEnv = saved


def save(path, **arrays):
    old = dict(np.load(path)) if os.path.exists(path) else {}
    old.update(arrays)
    np.savez(path, **old)
    log(f"wrote {os.path.relpath(path, ROOT)}: {sorted(old)}")


def rel(want, got):
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1.0)


def make_ant():
    import jax

    jit_env, op_env = jax_ant(ANT_ENVS), jax_ant(ANT_ENVS)
    op_env._step = op_env._step_impl
    acts = actions(ANT_MAX_STEPS, ANT_ENVS, 8)
    obs0 = jit_env.reset()
    op_env.reset()
    obs, rew, done, agree, horizon = [], [], [], [], None
    t = time.perf_counter()
    with rolled_scan():
        for k in range(ANT_MAX_STEPS):
            o1, r1, d1, _ = jit_env.step(acts[k])
            with jax.disable_jit():
                o2, r2, d2, _ = op_env.step(acts[k])
            err = (rel(o1, o2), rel(r1, r2))
            log(f"ant step {k + 1}: jitted vs op by op: obs {err[0]:.3e}, reward {err[1]:.3e} "
                f"({time.perf_counter() - t:.0f} s)")
            if max(err) > TOL or not np.array_equal(d1, d2):
                break
            if horizon is None and max(err) > TOL / 2:
                horizon = k
            obs.append(o1)
            rew.append(r1)
            done.append(d1)
            agree.append(err)
    parted = len(agree)  # the runs part at step parted + 1
    if horizon is None:
        horizon = parted
    obs, rew, done = obs[:horizon], rew[:horizon], done[:horizon]
    # the frame of env 0 after the golden's last step: a jitted run to there
    frame_env = jax_ant(ANT_ENVS)
    frame_env.reset()
    with rolled_scan():
        for k in range(horizon):
            frame_env.step(acts[k])
    frame = frame_env.render()
    frame_seg = jax_shape_seg(frame_env)
    log(f"ant: the runs part at step {parted + 1}; horizon {horizon} steps; frame {frame.shape} "
        f"{frame.dtype} std {frame.std():.2f}")
    save(ANT, horizon=np.int32(horizon), parted=np.int32(parted + 1), num_envs=np.int32(ANT_ENVS),
         obs0=obs0,
         obs=np.stack(obs), reward=np.stack(rew), done=np.stack(done),
         actions=acts[:horizon], agree=np.asarray(agree), frame=frame, frame_seg=frame_seg)


def jax_shape_seg(env):
    """The segmentation of a JAX vec-env's render() camera with each shape's
    index + 1 as its id (which shape each pixel hits): render()'s call
    (test_isaacgym_tpu/envs/rl_env.py:80-110) with that segmentation."""
    import jax.numpy as jnp
    from test_isaacgym_tpu.render.camera import look_at_quat
    from test_isaacgym_tpu.render.raster import (
        render_camera_batch, shape_world_poses, tables_from_scene)

    tb = tables_from_scene(env.sim.scene)
    sp, sq = shape_world_poses(env.state, env.sim.params, tb, env.sim.scene)
    eye, target = env._camera()
    quat = look_at_quat(eye, target)
    _, _, seg, _ = render_camera_batch(
        jnp.asarray(eye, jnp.float32)[None], jnp.asarray(quat, jnp.float32)[None],
        sp[:1], sq[:1], env.sim.params.shape_size[:1], tb.kind, tb.color,
        np.arange(1, len(tb.kind) + 1, dtype=np.int32), np.array([0, 0, 1, 0], np.float32),
        np.array([-0.3, -0.3, -0.9], np.float32) / np.linalg.norm([0.3, 0.3, 0.9]),
        np.array([0.8, 0.8, 0.8], np.float32), np.array([0.25, 0.25, 0.25], np.float32),
        np.array([0.32, 0.45, 0.6], np.float32), 90.0, width=320, height=240, far=100.0)
    return np.asarray(seg)[0]


def make_ant_big():
    import jax
    import torch

    from chip_smoke import ant_stats

    acts = actions(BIG_STEPS, BIG_ENVS, 8)
    out = {}
    for mode in ("jit", "opbyop"):
        env = jax_ant(BIG_ENVS)
        if mode == "opbyop":
            env._step = env._step_impl
        env.reset()
        reset = np.zeros(BIG_ENVS, bool)
        t = time.perf_counter()
        with rolled_scan(), (jax.disable_jit() if mode == "opbyop" else contextlib.nullcontext()):
            for k in range(BIG_STEPS):
                o, _, d, _ = env.step(acts[k])
                reset |= np.asarray(d)
                if k % 20 == 0:
                    log(f"ant_big {mode} step {k + 1}: {time.perf_counter() - t:.0f} s")
        stats, _ = ant_stats(torch.as_tensor(np.asarray(o)), torch.as_tensor(reset))
        for name, v in zip(("reset", "left", "height"), stats):
            out[f"big_{name}_{mode}"] = np.float64(v)
        log(f"ant_big {mode}: reset share {stats[0]:.6f}, left the scene {stats[1]:.6f}, "
            f"mean torso height of the others {stats[2]:.6f}")
    save(ANT, big_envs=np.int32(BIG_ENVS), big_steps=np.int32(BIG_STEPS), **out)


def make_franka():
    import test_isaacgym_tpu.envs.rl_env as jrl

    with jax_franka_standin():
        env = jrl.FrankaReachVecEnv(num_envs=FRANKA_ENVS)
    acts = actions(FRANKA_STEPS, FRANKA_ENVS, 7)
    obs, rew = [env.reset()], [np.zeros(FRANKA_ENVS, np.float32)]
    for k in range(FRANKA_STEPS):
        o, r, _, _ = env.step(acts[k])
        if (k + 1) % FRANKA_EVERY == 0:
            obs.append(o)
            rew.append(r)
    save(FRANKA, num_envs=np.int32(FRANKA_ENVS), steps=np.int32(FRANKA_STEPS),
         every=np.int32(FRANKA_EVERY), obs=np.stack(obs), reward=np.stack(rew))


def make_render():
    import chip_smoke
    import test_isaacgym_tpu.assets.sdf as jsdf
    import test_isaacgym_tpu.envs.franka_nut_bolt as jfnb
    from test_isaacgym_tpu.render import raster as jr
    from test_isaacgym_tpu_torch.envs import franka_nut_bolt as tfnb
    from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT
    from test_isaacgym_tpu_torch.envs.nut_bolt import NUT_STANDIN_ROOT, NUT_URDF

    tmp = tempfile.mkdtemp()
    root = os.path.join(tmp, "assets")
    robots = os.path.join(root, "urdf", "franka_description", "robots")
    os.makedirs(robots)
    shutil.copy(os.path.join(STANDIN_ROOT, tfnb.FRANKA_URDF),
                os.path.join(robots, "franka_panda.urdf"))
    shutil.copytree(os.path.join(NUT_STANDIN_ROOT, os.path.dirname(NUT_URDF)),
                    os.path.join(root, os.path.dirname(NUT_URDF)))
    saved = jfnb.ASSET_ROOT, jsdf._CACHE_DIR
    jfnb.ASSET_ROOT, jsdf._CACHE_DIR = root, os.path.join(tmp, "sdf")
    try:
        env = jfnb.FrankaNutBoltEnv(num_envs=1)
    finally:
        (jfnb.ASSET_ROOT, jsdf._CACHE_DIR) = saved
        shutil.rmtree(tmp, ignore_errors=True)
    sim = env.sim
    tb = jr.tables_from_scene(sim.scene)
    out = chip_smoke.nut_scene_render(jr, sim, tb, *chip_smoke.RENDER_SMALL,
                                      np.arange(1, len(tb.kind) + 1, dtype=np.int32))
    rgba, depth, seg = (np.asarray(x)[0] for x in out)
    log(f"render: {rgba.shape}, {int(np.isfinite(depth).sum())} pixels hit, "
        f"shapes {np.unique(seg).tolist()}")
    save(RENDER, eye=np.asarray(chip_smoke.RENDER_EYE, np.float32),
         target=np.asarray(chip_smoke.RENDER_TARGET, np.float32),
         rgba=rgba, depth=depth, seg=seg)


def main(parts):
    parts = parts or ["ant", "ant_big", "franka", "render"]
    for p in parts:
        t = time.perf_counter()
        {"ant": make_ant, "ant_big": make_ant_big, "franka": make_franka,
         "render": make_render}[p]()
        log(f"{p}: {time.perf_counter() - t:.0f} s")


if __name__ == "__main__":
    main(sys.argv[1:])

#!/usr/bin/env python3
"""Remake the goldens of the gymapi facade's scenes with the JAX facade.

    PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_use_fusion_emitters=false \\
        python tools/make_gym_goldens.py [balls] [franka] [interop]

With no argument it makes all three. Each scene is
test_isaacgym_tpu_torch/envs/gym_scenes.py's, built through the JAX
package's gymapi; each file goes under test_isaacgym_tpu_torch/assets/data/:

  balls    gym_balls_standin.npz: 4 pyramids (120 balls, so the sphere-world
           solve runs), the wrapped root tensor's positions `pos` (7, 120,
           3) at steps 0, 10, ..., 60.
  franka   gym_franka_osc_standin.npz: 8 envs of examples/franka_osc.py's
           loop on the Panda stand-in, `hand_pos` (7, 8, 3) and `dof_pos`
           (7, 8, 9) at steps 0, 10, ..., 60; and `track_err`, the mean
           tracking error after step 150 of the example's 300 steps of the
           same 8 envs (every env tracks the same circle from the same
           pose, so it is the mean at any width).
  interop  gym_interop_standin.npz: 2 envs of examples/interop_torch.py's
           scene, 30 frames; env 0's last colour image `rgb` (128, 128, 3)
           and segmentation `seg` (128, 128) (the ball's id is 1).
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "test_isaacgym_tpu_torch", "assets", "data")
BALLS, FRANKA, INTEROP = (os.path.join(DATA, f) for f in (
    "gym_balls_standin.npz", "gym_franka_osc_standin.npz", "gym_interop_standin.npz"))
BALL_PYRAMIDS, GOLDEN_STEPS, EVERY = 4, 60, 10
FRANKA_ENVS, FRANKA_TRACK_STEPS = 8, 300
INTEROP_ENVS, INTEROP_FRAMES = 2, 30


def log(*a):
    print(*a, flush=True)


def balls_golden(gymapi, gymtorch):
    """(7, F, 3) root positions every EVERY steps to GOLDEN_STEPS."""
    from test_isaacgym_tpu_torch.envs import gym_scenes

    gym, sim, _ = gym_scenes.balls(gymapi, BALL_PYRAMIDS)
    root = gymtorch.wrap_tensor(gym.acquire_actor_root_state_tensor(sim))
    out = []
    for k in range(GOLDEN_STEPS + 1):
        if k % EVERY == 0:
            gym.refresh_actor_root_state_tensor(sim)
            out.append(root[:, :3].numpy().copy())
        if k < GOLDEN_STEPS:
            gym.simulate(sim)
    return np.stack(out)


def franka_golden(gymapi, gymtorch, steps, every):
    """(snapshots every `every` steps as a dict of stacked arrays, the mean
    tracking error) of `steps` steps of the OSC loop on FRANKA_ENVS envs."""
    from test_isaacgym_tpu_torch.envs import gym_scenes

    gym, sim, scene = gym_scenes.franka_osc(gymapi, FRANKA_ENVS)
    loop = gym_scenes.OscLoop(gym, gymapi, gymtorch, sim, scene)
    snaps = []
    for itr in range(steps):
        if every and itr % every == 0:
            snaps.append(loop.snapshot())
        loop.step(itr)
    if every and steps % every == 0:
        snaps.append(loop.snapshot())
    stacked = {k: np.stack([s[k] for s in snaps]) for k in snaps[0]} if snaps else {}
    return stacked, loop.mean_error()


def interop_golden(gymapi, gymtorch):
    from test_isaacgym_tpu_torch.envs import gym_scenes

    gym, sim, envs, cams = gym_scenes.interop(gymapi, INTEROP_ENVS)
    gym.prepare_sim(sim)
    for _ in range(INTEROP_FRAMES):
        img = gym_scenes.interop_frame(gym, gymapi, gymtorch, sim, envs[0], cams[0])
    seg = gym.get_camera_image(sim, envs[0], cams[0], gymapi.IMAGE_SEGMENTATION)
    return np.asarray(img)[..., :3].copy(), np.asarray(seg)


def main(parts):
    from test_isaacgym_tpu import gymapi, gymtorch

    if "balls" in parts:
        t = time.time()
        pos = balls_golden(gymapi, gymtorch)
        np.savez_compressed(BALLS, pos=pos.astype(np.float32), every=EVERY)
        log(f"balls: {pos.shape} in {time.time() - t:.1f} s -> {BALLS}")
    if "franka" in parts:
        t = time.time()
        snaps, _ = franka_golden(gymapi, gymtorch, GOLDEN_STEPS, EVERY)
        _, err = franka_golden(gymapi, gymtorch, FRANKA_TRACK_STEPS, 0)
        np.savez_compressed(FRANKA, hand_pos=snaps["hand_pos"], dof_pos=snaps["dof_pos"],
                            every=EVERY, num_envs=FRANKA_ENVS, track_err=err,
                            track_steps=FRANKA_TRACK_STEPS)
        log(f"franka: mean tracking error {err:.6f} m after {FRANKA_TRACK_STEPS} steps, "
            f"{time.time() - t:.1f} s -> {FRANKA}")
    if "interop" in parts:
        t = time.time()
        rgb, seg = interop_golden(gymapi, gymtorch)
        np.savez_compressed(INTEROP, rgb=rgb, seg=seg, frames=INTEROP_FRAMES)
        log(f"interop: frame {rgb.shape}, ball on {(seg == 1).mean():.4f} of the pixels, "
            f"{time.time() - t:.1f} s -> {INTEROP}")


if __name__ == "__main__":
    main(sys.argv[1:] or ["balls", "franka", "interop"])

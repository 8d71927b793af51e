"""Port parity: the RL vec-env surface (envs/rl_env.py) against the JAX
package.

The Ant (the committed stand-in, 4 envs, actions uniform in [-1, 1] from
RandomState(0)): its first steps against the JAX env stepped op by op, then
every step to the golden's horizon against ant_standin.npz (the JAX env's
jitted run, which ends before its own jitted and op-by-op runs differ by
half of 1e-4 * max(|ref|, 1): 28 steps, where they part at step 33); the
auto-reset (one env's torso set low: only that
env returns to its initial state, in the port as in the JAX env);
FrankaReachVecEnv at 4 envs against the JAX env and at 8 envs against
franka_reach_standin.npz; and render() against the JAX frame. Remake the
goldens with tools/make_rl_goldens.py.
"""
import contextlib
import functools
import os

import jax
import numpy as np
import pytest
import torch

import test_isaacgym_tpu  # noqa: F401  (CPU platform before jax init)
import test_isaacgym_tpu.envs.franka as jfranka
import test_isaacgym_tpu.envs.rl_env as jrl
from test_isaacgym_tpu_torch.core.state import to_numpy
from test_isaacgym_tpu_torch.envs import rl_env as trl
from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT

DATA = os.path.join(os.path.dirname(trl.ASSET_ROOT))
TOL = 1e-4
JAX_STEPS = 2  # steps of the JAX env op by op (~5 s each)
# render() frames: pixels whose colour differs by more than one count, all
# at a silhouette, where a grazing ray may pick another shape
FRAME_SHARE = 0.01


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1.0)


def actions(steps, envs, dofs):
    return np.random.RandomState(0).uniform(-1, 1, (steps, envs, dofs)).astype(np.float32)


@contextlib.contextmanager
def jax_standins():
    """The JAX envs on the port's stand-ins: the Ant MJCF and the Panda."""
    saved = jrl.ASSET_ROOT, jfranka.FrankaOscEnv
    jrl.ASSET_ROOT = trl.ASSET_ROOT
    jfranka.FrankaOscEnv = functools.partial(saved[1], asset_root=STANDIN_ROOT)
    try:
        yield
    finally:
        jrl.ASSET_ROOT, jfranka.FrankaOscEnv = saved


def jax_env(task, num_envs):
    with jax_standins():
        env = jrl.make(task=task, num_envs=num_envs)
    env._step = env._step_impl  # op by op under disable_jit
    return env


def jax_steps(env, acts):
    out = []
    for a in acts:
        with jax.disable_jit():
            out.append([np.asarray(x) for x in env.step(a)[:3]])
    return out


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(DATA, "ant_standin.npz"))


def test_make_surface():
    env = trl.make(task="Ant", num_envs=2, sim_device="cpu", rl_device="cpu")
    assert env.is_vector_env and env.action_space.shape == (8,)
    assert env.observation_space.shape == (27,)
    obs = env.reset()
    assert obs.shape == (2, 27) and obs.device.type == "cpu"
    o, r, d, info = env.step(env.action_space.sample()[None].repeat(2, 0))
    assert (o.shape, r.shape, d.shape, d.dtype, info) == ((2, 27), (2,), (2,), torch.bool, {})
    with pytest.raises(ValueError):
        trl.make(task="Humanoid", sim_device="cpu")


def test_ant_first_steps_like_jax():
    acts = actions(JAX_STEPS, 4, 8)
    je = jax_env("Ant", 4)
    te = trl.make(task="Ant", num_envs=4, sim_device="cpu", rl_device="cpu")
    assert rel(te.reset().numpy(), je.reset()) == 0.0
    for k, (jo, jr_, jd) in enumerate(jax_steps(je, acts)):
        o, r, d, _ = te.step(acts[k])
        assert rel(o, jo) <= TOL and rel(r, jr_) <= TOL, k
        np.testing.assert_array_equal(d.numpy(), jd)


def test_ant_against_golden_to_horizon(golden):
    """Every step of the golden (the JAX env's jitted run, to where its own
    jitted and op-by-op runs differ by half the tolerance) within 1e-4 *
    max(|ref|, 1)."""
    horizon = int(golden["horizon"])
    assert horizon >= 10 and len(golden["obs"]) == horizon
    te = trl.make(task="Ant", num_envs=int(golden["num_envs"]), sim_device="cpu", rl_device="cpu")
    np.testing.assert_array_equal(te.reset().numpy(), golden["obs0"])
    worst = 0.0
    for k in range(horizon):
        o, r, d, _ = te.step(golden["actions"][k])
        worst = max(worst, rel(o, golden["obs"][k]), rel(r, golden["reward"][k]))
        assert worst <= TOL, (k, worst)
        np.testing.assert_array_equal(d.numpy(), golden["done"][k])


def test_auto_reset_only_the_fallen_env():
    """Env 2's torso set to 0.1 m: that env (and no other) is done and
    comes back as its initial state; the others step as if nothing
    happened. The JAX env (op by op) does the same."""
    acts = np.zeros((4, 8), np.float32)
    ports = [trl.make(task="Ant", num_envs=4, sim_device="cpu", rl_device="cpu") for _ in range(2)]
    low = ports[0].state.root_pos.clone()
    low[2, :, 2] = 0.1
    ports[0].state = ports[0].state._replace(root_pos=low)
    (o, _, d, _), (o_ref, _, _, _) = (p.step(acts) for p in ports)
    np.testing.assert_array_equal(d.numpy(), [False, False, True, False])
    init = to_numpy(ports[0].sim.initial_state)
    for key, v in to_numpy(ports[0].state).items():
        if v is not None and v.ndim and v.shape[0] == 4:
            np.testing.assert_array_equal(v[2], init[key][2], err_msg=key)
    keep = [0, 1, 3]
    np.testing.assert_array_equal(o.numpy()[keep], o_ref.numpy()[keep])
    assert int(ports[0].state.steps) == int(ports[1].state.steps) == 1  # the clock stays

    je = jax_env("Ant", 4)
    je.reset()
    je.state = je.state._replace(root_pos=je.state.root_pos.at[2, :, 2].set(0.1))
    ((jo, _, jd),) = jax_steps(je, acts[None])
    np.testing.assert_array_equal(jd, d.numpy())
    assert rel(o, jo) <= TOL


def test_franka_reach_like_jax():
    acts = actions(JAX_STEPS, 4, 7)
    je = jax_env("Franka", 4)
    te = trl.make(task="Franka", num_envs=4, sim_device="cpu", rl_device="cpu")
    assert te.action_space.shape == (7,) and te.observation_space.shape == (14,)
    assert rel(te.reset().numpy(), je.reset()) <= TOL
    for k, (jo, jr_, jd) in enumerate(jax_steps(je, acts)):
        o, r, d, _ = te.step(acts[k])
        assert rel(o, jo) <= TOL and rel(r, jr_) <= TOL, k
        assert not d.any() and not jd.any()


def test_franka_reach_against_golden():
    g = np.load(os.path.join(DATA, "franka_reach_standin.npz"))
    n, steps, every = int(g["num_envs"]), int(g["steps"]), int(g["every"])
    te = trl.make(task="Franka", num_envs=n, sim_device="cpu", rl_device="cpu")
    acts = actions(steps, n, 7)
    assert rel(te.reset().numpy(), g["obs"][0]) <= TOL
    for k in range(steps):
        o, r, _, _ = te.step(acts[k])
        if (k + 1) % every == 0:
            i = (k + 1) // every
            assert rel(o, g["obs"][i]) <= TOL and rel(r, g["reward"][i]) <= TOL, k


def frames_match(got, want, seg=None, want_seg=None, share=FRAME_SHARE):
    """Colour within one count, except on at most `share` of the pixels;
    with segmentations, equal except on those pixels too."""
    assert got.shape == want.shape and got.dtype == np.uint8
    bad = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1) > 1
    if seg is not None:
        bad |= seg != want_seg
    assert bad.mean() <= share, bad.mean()
    return bad.mean()


def test_render_like_jax(golden):
    """render() of env 0: at reset against the JAX env's render(), and after
    the golden's steps against its frame and per-shape segmentation."""
    je = jax_env("Ant", 4)
    je.reset()
    te = trl.make(task="Ant", num_envs=4, sim_device="cpu", rl_device="cpu")
    te.reset()
    frame = te.render()
    assert frame.shape == (240, 320, 3) and frame.dtype == np.uint8 and frame.std() > 5
    frames_match(frame, np.asarray(je.render()))
    for a in golden["actions"]:
        te.step(a)
    seg = te.camera_images(seg=np.arange(1, 14, dtype=np.int32))[2].numpy()
    frames_match(te.render(), golden["frame"], seg, golden["frame_seg"])
    assert len(np.unique(golden["frame_seg"])) > 5  # the torso and legs are in view

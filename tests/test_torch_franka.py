"""Port parity: the flagship Franka OSC path against the JAX package.

8 envs of FrankaOscEnv on the mesh-free Panda stand-in
(test_isaacgym_tpu_torch/assets/data/panda_standin), built by each package.
The port's own scene build must give the JAX env's state and params; then
both start from the JAX env's state and params (carried across with
core/state.py::from_numpy) and run 50 control+physics steps, compared every
10 steps on hand_pos, dof_pos and dof_vel at the goldens' rule,
1e-4 * max(|ref|, 1) (tests/test_goldens.py::_check); the tracking error
after 50 steps must match too. The JAX env jits one 10-step chunk and calls
it five times.

The committed golden franka_osc_standin.npz (the JAX env's hand_pos and
dof_pos at steps 0, 10, ..., 50) must still be reproduced by the JAX package
and by the port on the CPU; chip_smoke.py holds the card against it.
Regenerate it, and print the JAX env's median tracking error that
chip_smoke.py bounds, with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_franka.py
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_isaacgym_tpu.control import osc as josc
from test_isaacgym_tpu.envs.franka import FrankaOscEnv as JaxFranka
from test_isaacgym_tpu_torch.control import osc as tosc
from test_isaacgym_tpu_torch.core.state import PhysParams, SimState, from_numpy, to_numpy
from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT, FrankaOscEnv
from test_torch_kinematics import close

GOLDEN = os.path.join(STANDIN_ROOT, "franka_osc_standin.npz")
ATOL = 1e-4
N_ENVS, CHUNK, CHUNKS = 8, 10, 5


_check = functools.partial(close, tol=ATOL)  # the goldens' rule


def jax_trajectory(num_envs=N_ENVS, chunks=CHUNKS):
    """The JAX env's snapshots every CHUNK steps, as a dict of (chunks+1,
    N, .) numpy arrays, and the env, left at its final state."""
    env = JaxFranka(num_envs=num_envs, asset_root=STANDIN_ROOT)
    run = jax.jit(env.rollout_fn(CHUNK))
    s, snaps = env.sim.state, []
    for k in range(chunks + 1):
        snaps.append((np.array(s.body_pos[:, env.hand_body]), np.array(s.dof_pos),
                      np.array(s.dof_vel)))
        if k < chunks:
            s = run(s)
    env.sim.state = s
    hand, dof_pos, dof_vel = (np.stack(x) for x in zip(*snaps))
    return dict(hand_pos=hand, dof_pos=dof_pos, dof_vel=dof_vel), env


def _numpy(value):
    """A JAX NamedTuple as the dict of numpy arrays `from_numpy` takes."""
    return {k: None if v is None else np.asarray(v) for k, v in value._asdict().items()}


def port_trajectory(env, state=None):
    run = env.rollout_fn(CHUNK)
    s, snaps = env.sim.state if state is None else state, []
    for k in range(CHUNKS + 1):
        snaps.append((s.body_pos[:, env.hand_body].numpy(), s.dof_pos.numpy(), s.dof_vel.numpy()))
        if k < CHUNKS:
            s = run(s)
    env.sim.state = s
    hand, dof_pos, dof_vel = (np.stack(x) for x in zip(*snaps))
    return dict(hand_pos=hand, dof_pos=dof_pos, dof_vel=dof_vel)


@pytest.fixture(scope="module")
def jax_run():
    return jax_trajectory()


@pytest.fixture(scope="module")
def port_env():
    return FrankaOscEnv(num_envs=N_ENVS, device="cpu")


def test_port_scene_build_matches_jax(jax_run, port_env):
    """The port's own build gives the JAX env's initial state and params."""
    jenv = jax_run[1]
    got_state = to_numpy(port_env.sim.initial_state)
    for k, want in _numpy(jenv.sim.initial_state).items():
        if want is None:
            assert got_state[k] is None, k
        else:
            _check(got_state[k], want, f"state.{k}")
    got_params = to_numpy(port_env.sim.params)
    for k, want in _numpy(jenv.sim.params).items():
        np.testing.assert_array_equal(got_params[k], want, k)
    assert port_env.hand_body == jenv.hand_body
    _check(port_env.init_hand_pos.numpy(), jenv.init_hand_pos, "init_hand_pos")


def test_rollout_matches_jax(jax_run, port_env):
    """50 steps from the JAX env's state and params carried across. dof_vel
    holds the same 1e-4 rule as the positions."""
    want, jenv = jax_run
    state = from_numpy(_numpy(jenv.sim.initial_state), SimState, "cpu")
    port_env.sim.params = from_numpy(_numpy(jenv.sim.params), PhysParams, "cpu")
    got = port_trajectory(port_env, state)
    for k in ("hand_pos", "dof_pos", "dof_vel"):
        for i in range(CHUNKS + 1):
            _check(got[k][i], want[k][i], f"{k} at step {CHUNK * i}")
    steps = CHUNK * CHUNKS
    assert int(port_env.sim.state.steps) == steps
    np.testing.assert_allclose(port_env.tracking_error(steps), jenv.tracking_error(steps), atol=ATOL)


def test_golden_reproduced_by_jax_and_port(jax_run):
    """The committed golden cannot go stale unnoticed: the JAX package
    reproduces it, and so does the port from its own scene build."""
    golden = np.load(GOLDEN)
    got = port_trajectory(FrankaOscEnv(num_envs=N_ENVS, device="cpu"))
    for k in ("hand_pos", "dof_pos"):
        assert golden[k].shape == (CHUNKS + 1, N_ENVS, golden[k].shape[-1])
        for i in range(CHUNKS + 1):
            _check(jax_run[0][k][i], golden[k][i], f"jax {k} at step {CHUNK * i}")
            _check(got[k][i], golden[k][i], f"port {k} at step {CHUNK * i}")


def test_default_device_is_cuda():
    """FrankaOscEnv runs on CUDA unless asked for the CPU; without a card
    it raises instead of falling back."""
    fields = {f.name: f.default for f in dataclasses.fields(FrankaOscEnv)}
    assert fields["device"] == "cuda"
    if torch.cuda.is_available():
        assert FrankaOscEnv(num_envs=1).sim.state.dof_pos.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            FrankaOscEnv(num_envs=1)


def _osc_inputs(seed, N=16, D=7):
    rng = np.random.RandomState(seed)
    J = rng.normal(size=(N, 6, D)) * 0.5
    A = rng.normal(size=(N, D, D))
    mm = A @ np.swapaxes(A, -1, -2) * 0.1 + np.eye(D)
    arrays = dict(
        j_eef=J, mm=mm, dpose=rng.normal(size=(N, 6)) * 0.1,
        dof_pos=rng.uniform(-2, 2, (N, D)), dof_vel=rng.normal(size=(N, D)),
        hand_vel=rng.normal(size=(N, 6)) * 0.2, default_dof_pos=rng.uniform(-1, 1, D),
    )
    return {k: np.asarray(v, np.float32) for k, v in arrays.items()}


@pytest.mark.parametrize("kw", [{}, dict(kp=40.0, kd=5.0, kp_null=2.0, kd_null=1.0)])
def test_control_osc_and_ik_match_jax(kw):
    a = _osc_inputs(7)
    want = josc.control_osc(**{k: jnp.asarray(v) for k, v in a.items()}, **kw)
    got = tosc.control_osc(**{k: torch.as_tensor(v) for k, v in a.items()}, **kw)
    _check(got.numpy(), want, "control_osc")
    for damping in (0.05, 0.2):
        want = josc.control_ik(jnp.asarray(a["j_eef"]), jnp.asarray(a["dpose"]), damping)
        got = tosc.control_ik(torch.as_tensor(a["j_eef"]), torch.as_tensor(a["dpose"]), damping)
        _check(got.numpy(), want, "control_ik")


if __name__ == "__main__":
    traj, env = jax_trajectory()
    np.savez(GOLDEN, hand_pos=traj["hand_pos"], dof_pos=traj["dof_pos"])
    print(f"wrote {GOLDEN}: hand_pos {traj['hand_pos'].shape}, dof_pos {traj['dof_pos'].shape}")
    # chip_smoke.py's bound on the median tracking error after its 200 steps
    err50 = np.median(env.tracking_error(CHUNK * CHUNKS))
    run = jax.jit(env.rollout_fn(CHUNK))
    s = env.sim.state
    for _ in range(200 // CHUNK - CHUNKS):
        s = run(s)
    env.sim.state = s
    print(f"JAX env (CPU) median tracking error: after 50 steps {err50:.6f} m, "
          f"after 200 steps {np.median(env.tracking_error(200)):.6f} m")

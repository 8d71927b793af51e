"""Port parity: the UAV-car pursuit env with visual servo (envs/uav_car.py)
and what it is built of (control/guidance.py, control/servo.py, the
projection of render/camera.py) against the JAX package.

  * guidance, servo and projection functions on the same random inputs
    (RandomState seeds below), tolerance 1e-5 * max(|ref|, 1), with the
    servo's special cases: zero pixel error, the optical axis already on
    the target and opposite it, and points behind the camera;
  * one env step from the same state, carried across with
    ServoState.from_numpy, with half the cameras turned away from their car
    so that the step takes the behind-camera acquisition branch there;
  * the 16-env, 300-step run of tests/goldens/uav_car.npz: the port's
    against the JAX env's and against the golden every 15 steps, the
    goldens' rule 1e-4 * max(|ref|, 1);
  * the 4-env, 600-step behaviour of tests/test_vecenv.py: cars on their
    loiter circles, every car's pixel within 2 px of the image centre.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_isaacgym_tpu.control.guidance as jg
import test_isaacgym_tpu.control.servo as js
import test_isaacgym_tpu.render.camera as jcam
import test_isaacgym_tpu_torch.control.guidance as tg
import test_isaacgym_tpu_torch.control.servo as ts
import test_isaacgym_tpu_torch.render.camera as tcam
from test_isaacgym_tpu.core.config import CameraProperties as JaxProps
from test_isaacgym_tpu.envs.uav_car import UavCarEnv as JaxEnv
from test_isaacgym_tpu.math.quat import matrix_to_quat
from test_isaacgym_tpu_torch.core.config import CameraProperties
from test_isaacgym_tpu_torch.core.state import to_numpy
from test_isaacgym_tpu_torch.envs.uav_car import ServoState, UavCarEnv
from test_torch_kinematics import close

TOL, ATOL = 1e-5, 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "uav_car.npz")
GOLDEN_ENVS, GOLDEN_EVERY, GOLDEN_CHUNKS = 16, 15, 20


def _rotations(rng, n):
    """n random rotation matrices (float32), from look_at_quat."""
    return np.stack([jcam.quat_to_mat_np(jcam.look_at_quat(np.zeros(3), rng.randn(3)))
                     for _ in range(n)]).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    """fn of both packages on the same numpy inputs: (JAX's, the port's)."""
    want = fn_j(*[jnp.asarray(a) for a in arrays])
    got = fn_t(*[torch.as_tensor(a) for a in arrays])
    if isinstance(want, tuple):
        return [np.asarray(w) for w in want], [g.numpy() for g in got]
    return [np.asarray(want)], [got.numpy()]


def _close_all(want, got, what):
    for i, (w, g) in enumerate(zip(want, got)):
        close(g, w, f"{what}[{i}]", tol=TOL)


def test_guidance_matches_jax():
    rng = np.random.RandomState(0)
    pos = rng.uniform(-50, 50, (64, 3)).astype(np.float32)
    pos[:4, :2] = [[0.001, 0.0], [10.0, 0.0], [0.0, -10.0], [7.0, 7.1]]  # r ~ 0 and r ~ rd
    target = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    _close_all(*_both(lambda p, t: jg.cclvf(p, t, 7.0, 10.0),
                      lambda p, t: tg.cclvf(p, t, 7.0, 10.0), pos, target), "cclvf")
    vel = rng.randn(64, 3).astype(np.float32)
    vel[0] = [-1.0, 0.0, 0.0]  # yaw = pi: the sign of the quaternion
    want, got = _both(jg.heading_quat, tg.heading_quat, vel)
    _close_all(want, got, "heading_quat")


def test_servo_matches_jax():
    rng = np.random.RandomState(1)
    K_j = np.asarray(js.camera_matrix(160, 90, 90.0))
    K_t = ts.camera_matrix(160, 90, 90.0, device="cpu")
    np.testing.assert_array_equal(K_t.numpy(), K_j)
    close(ts.camera_matrix(320, 240, 75.0, "cpu").numpy(),
          np.asarray(js.camera_matrix(320, 240, 75.0)), "camera_matrix", tol=TOL)
    R = _rotations(rng, 16)
    pix = rng.uniform(-60, 60, (16, 2)).astype(np.float32)
    pix[:2] = 0.0  # zero pixel error
    _close_all(*_both(lambda p: js.pixel_to_ray(p, jnp.asarray(K_j)),
                      lambda p: ts.pixel_to_ray(p, K_t), pix + 40.0), "pixel_to_ray")
    for name in ("servo_ext_pixel", "recenter_rotation"):
        _close_all(*_both(lambda r, p: getattr(js, name)(r, p, jnp.asarray(K_j)),
                          lambda r, p: getattr(ts, name)(r, p, K_t), R, pix), name)
    rpy = rng.uniform(-np.pi, np.pi, (16, 3)).astype(np.float32)
    _close_all(*_both(js.gimbal_rot, ts.gimbal_rot, rpy), "gimbal_rot")
    # align_axis_to: random directions, the axis itself and its opposite
    v = rng.randn(16, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[0], v[1] = R[0, :, 0], -R[1, :, 0]
    _close_all(*_both(js.align_axis_to, ts.align_axis_to, R, v), "align_axis_to")
    near = R + rng.uniform(-0.01, 0.01, R.shape).astype(np.float32)
    _close_all(*_both(js._orthonormalize, ts._orthonormalize, near), "_orthonormalize")


def test_projection_matches_jax():
    rng = np.random.RandomState(2)
    cam_pos = rng.uniform(-5, 5, (32, 3)).astype(np.float32)
    cam_quat = rng.randn(32, 4).astype(np.float32)
    cam_quat /= np.linalg.norm(cam_quat, axis=-1, keepdims=True)
    pts = rng.uniform(-20, 20, (32, 3)).astype(np.float32)
    kw = dict(width=160, height=90, horizontal_fov=75.0)
    want, got = _both(lambda c, q, p: jcam.world_to_pixel(c, q, p, JaxProps(**kw)),
                      lambda c, q, p: tcam.world_to_pixel(c, q, p, CameraProperties(**kw)),
                      cam_pos, cam_quat, pts)
    assert (want[1] < 0).any() and (want[1] > 0).any()  # points behind and in front
    _close_all(want, got, "world_to_pixel")
    _close_all(*_both(jcam.quat_inv_j, tcam.quat_inv_j, cam_quat), "quat_inv_j")
    eye, target = np.array([1.0, 2.0, 3.0]), np.array([-2.0, 0.5, 0.0])
    for up in ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0)):
        np.testing.assert_array_equal(tcam.look_at_quat(eye, target, up),
                                      jcam.look_at_quat(eye, target, up))
    q = jcam.look_at_quat(eye, target)
    np.testing.assert_array_equal(tcam.quat_to_mat_np(q), jcam.quat_to_mat_np(q))
    np.testing.assert_array_equal(tcam.mat_to_quat_np(np.diag([1.0, -1.0, -1.0])),
                                  jcam.mat_to_quat_np(np.diag([1.0, -1.0, -1.0])))
    np.testing.assert_array_equal(tcam.view_matrix(eye, q), jcam.view_matrix(eye, q))
    np.testing.assert_array_equal(tcam.proj_matrix(CameraProperties(**kw)),
                                  jcam.proj_matrix(JaxProps(**kw)))


@functools.lru_cache(maxsize=None)
def _jax_env(num_envs):
    env = JaxEnv(num_envs=num_envs)
    env.chunk = jax.jit(lambda s: env.rollout(GOLDEN_EVERY, s))
    return env


def test_step_from_a_carried_state_takes_the_behind_camera_branch_like_jax():
    jenv = _jax_env(GOLDEN_ENVS)
    start = jenv.chunk(jenv.init_state)[0]
    rot = np.array(start.cam_rot)
    rot[::2] = -rot[::2]  # half the cameras look up, away from their car
    rot[::2, :, 1] *= -1  # (keep them right-handed)
    jstate = start._replace(cam_rot=jnp.asarray(rot))
    env = UavCarEnv(num_envs=GOLDEN_ENVS, device="cpu")
    state = ServoState.from_numpy(
        {k: np.asarray(v) for k, v in start.sim._asdict().items() if v is not None}, rot, "cpu")
    _, depth = jcam.world_to_pixel(start.sim.root_pos[:, jenv.uav_slot],
                                   matrix_to_quat(jnp.asarray(rot)),
                                   start.sim.root_pos[:, jenv.car_slot], jenv._props())
    behind = np.asarray(depth) <= 1e-6
    assert behind[::2].all() and not behind[1::2].any()
    want_state, (want_pix, want_rpy) = jenv.step_fn(jstate)
    got_state, (got_pix, got_rpy) = env.step_fn(state)
    # (a pixel of a point behind the camera is undefined: compared in front only)
    for name, g, w in (("cam_rot", got_state.cam_rot, want_state.cam_rot),
                       ("rpy", got_rpy, want_rpy), ("pixel", got_pix[1::2], want_pix[1::2])):
        close(g.numpy(), np.asarray(w), name, tol=TOL)
    got = to_numpy(got_state.sim)
    for f in ("root_pos", "root_quat", "root_linvel"):
        close(got[f], np.asarray(getattr(want_state.sim, f)), f, tol=TOL)


def _snap(state, env):
    sim = state.sim
    return {"uav_pos": np.array(sim.root_pos[:, env.uav_slot]),
            "car_pos": np.array(sim.root_pos[:, env.car_slot]),
            "uav_quat": np.array(sim.root_quat[:, env.uav_slot]),
            "cam_rot": np.array(state.cam_rot)}


def test_golden_run_matches_jax_and_golden():
    golden = np.load(GOLDEN)
    jenv, env = _jax_env(GOLDEN_ENVS), UavCarEnv(num_envs=GOLDEN_ENVS, device="cpu")
    jstate, state = jenv.init_state, env.init_state
    for k in range(GOLDEN_CHUNKS + 1):
        want, got = _snap(jstate, jenv), _snap(state, env)
        for key, g in got.items():
            close(g, want[key], f"{key} after {GOLDEN_EVERY * k} steps", tol=ATOL)
            if key in golden.files:
                close(g, golden[key][k], f"golden {key} after {GOLDEN_EVERY * k} steps",
                      tol=ATOL)
        if k < GOLDEN_CHUNKS:
            jstate, (jpix, _) = jenv.chunk(jstate)
            state, (pix, _) = env.rollout(GOLDEN_EVERY, state)
            close(pix[-1].numpy(), np.asarray(jpix[-1]), f"pixel at step {GOLDEN_EVERY * (k + 1)}",
                  tol=ATOL)


def test_rollout_loiters_and_keeps_the_car_centred():
    """tests/test_vecenv.py::test_uav_car_rollout on the port."""
    env = UavCarEnv(num_envs=4, device="cpu")
    final, (pixels, rpy) = env.rollout(600)
    assert pixels.shape == (600, 4, 2) and rpy.shape == (600, 4, 3)
    car = final.sim.root_pos[:, env.car_slot]
    r = torch.linalg.vector_norm(car[:, :2] - env.target_w[:, :2], dim=1)
    assert torch.allclose(r, torch.full_like(r, 10.0), atol=0.5), r
    err = torch.linalg.vector_norm(
        env.car_pixel(final) - torch.tensor([env.cam_width / 2, env.cam_height / 2]), dim=1)
    assert (err < 2.0).all(), err


def test_default_device_is_cuda():
    """Without a card the default env raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        UavCarEnv(num_envs=1)


def test_step_fn_takes_the_scan_argument():
    """step_fn(state, _=None): the JAX env's trailing scan argument
    (envs/uav_car.py:108), with the JAX env's outputs."""
    import inspect

    assert (list(inspect.signature(UavCarEnv.step_fn).parameters)
            == list(inspect.signature(JaxEnv.step_fn).parameters))
    jenv = _jax_env(GOLDEN_ENVS)
    env = UavCarEnv(num_envs=GOLDEN_ENVS, device="cpu")
    want_state, (want_pix, want_rpy) = jenv.step_fn(jenv.init_state, None)
    got_state, (got_pix, got_rpy) = env.step_fn(env.init_state, None)
    for name, g, w in (("pixel", got_pix, want_pix), ("rpy", got_rpy, want_rpy),
                       ("root_pos", got_state.sim.root_pos, want_state.sim.root_pos)):
        close(g.numpy(), np.asarray(w), name, tol=ATOL)

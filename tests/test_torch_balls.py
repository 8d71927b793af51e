"""Port parity end to end: the balls world and a free-body scene.

The port's BallsEnv (CPU tensors, so the sphere-world solve takes its plain
version) against the JAX package's BallsEnv and against the committed
golden tests/goldens/balls_drop.npz; and a ground-free box + sphere scene
with forces, torques, force positions and damping against the JAX
Simulator. Tolerance: the goldens' rule, max |err| <= 1e-4 * max(|ref|, 1),
over the whole horizon (the port measured ~2e-5 from both after 120 steps).
"""
import os

import jax
import numpy as np
import torch

from test_isaacgym_tpu_torch.core.state import to_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "balls_drop.npz")
ATOL = 1e-4


def _check(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= ATOL * scale, f"{what}: max |err| {err:.3e} > {ATOL} * {scale:.3g}"


def test_balls_drop_matches_jax_and_golden():
    """4 pyramids (120 balls), 120 steps, checked every 10 steps."""
    from test_isaacgym_tpu.envs.balls import BallsEnv as JaxBalls
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv

    golden = np.load(GOLDEN)["pos"]
    jenv = JaxBalls(num_worlds=1, pyramids=4)
    env = BallsEnv(num_worlds=1, pyramids=4, device="cpu")
    jrun = jax.jit(jenv.rollout_fn(10))
    run = env.rollout_fn(10)
    js, s = jenv.sim.state, env.sim.state
    for k in range(golden.shape[0]):
        pos = s.root_pos[0].numpy()
        _check(pos, np.asarray(js.root_pos[0]), f"pos vs jax at step {10 * k}")
        _check(pos, golden[k], f"pos vs golden at step {10 * k}")
        if k + 1 < golden.shape[0]:
            js, s = jrun(js), run(s)
    _check(s.root_linvel[0].numpy(), np.asarray(js.root_linvel[0]), "linvel vs jax")
    _check(s.contact_force[0].numpy(), np.asarray(js.contact_force[0]), "contact force vs jax")
    assert int(s.steps) == 120 and s.steps.dtype == torch.int32


def test_balls_world_settles():
    """120-ball world: balls fall, pile up, never sink or explode, and the
    pile's kinetic energy decays (port of test_sphere_world's test)."""
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv

    env = BallsEnv(num_worlds=1, pyramids=4, device="cpu")
    run = env.rollout_fn(60)
    s = run(env.sim.state)
    v_mid = float(s.root_linvel.abs().max())
    for _ in range(3):
        s = run(s)
    z = s.root_pos[0, :, 2].numpy()
    v = s.root_linvel[0].numpy()
    assert z.min() > 0.15, f"sank: zmin={z.min()}"
    assert z.max() < 3.0, f"exploded: zmax={z.max()}"
    assert np.abs(v).max() < max(0.7 * v_mid, 0.6), "energy not decaying"
    assert s.contact_force[0, :, 2].max() > 0  # ground support


def test_batched_worlds():
    """num_worlds > 1 batches identical worlds along the env axis."""
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv

    env = BallsEnv(num_worlds=2, pyramids=3, device="cpu")  # 90 balls x 2 worlds
    s = env.rollout_fn(30)(env.sim.state)
    z = s.root_pos[..., 2].numpy()
    assert z.shape[0] == 2
    assert z.min() > 0.15
    np.testing.assert_allclose(z[0], z[1], atol=1e-5)


def _free_body_sim(pkg, device=None):
    """8 envs of one box and one sphere, no ground; the two actors share a
    collision filter bit, so the contact table stays empty."""
    assets = __import__(f"{pkg}.assets.primitives", fromlist=["x"])
    config = __import__(f"{pkg}.core.config", fromlist=["x"])
    scene = __import__(f"{pkg}.core.scene", fromlist=["x"])
    sim_mod = __import__(f"{pkg}.core.sim", fromlist=["x"])
    rng = np.random.RandomState(11)
    b = scene.SceneBuilder(config.SimParams(dt=1 / 60, substeps=2))
    box = assets.create_box(0.3, 0.2, 0.1, density=800.0,
                            linear_damping=0.1, angular_damping=0.3)
    ball = assets.create_sphere(0.15, density=500.0,
                                linear_damping=0.05, angular_damping=0.2)
    for e in range(8):
        b.create_env((-1, -1, 0), (1, 1, 2), 4)
        q = rng.normal(size=4)
        b.create_actor(e, box, pos=(0, 0, 1), quat=q / np.linalg.norm(q),
                       name="box", group=0, filter=1)
        b.create_actor(e, ball, pos=(0.5, 0, 1), name="ball", group=0, filter=1)
    if device is None:
        return sim_mod.Simulator(*b.finalize())
    return sim_mod.Simulator(*b.finalize(device), device=device)


def test_free_body_scene_matches_jax():
    """Phase B/D of free bodies (gyroscopic term, spd_solve, forces at
    points, damping) over 50 steps, two substeps each."""
    jsim = _free_body_sim("test_isaacgym_tpu")
    sim = _free_body_sim("test_isaacgym_tpu_torch", "cpu")
    assert not sim.stepper.contact.enabled and not jsim.stepper.contact.enabled

    rng = np.random.RandomState(5)
    root = np.asarray(jsim.root_state).copy()  # (16, 13) env-local
    root[:, 7:10] = rng.uniform(-1, 1, (16, 3))
    root[:, 10:13] = rng.uniform(-4, 4, (16, 3))
    jsim.root_state = root
    sim.root_state = root
    forces = rng.uniform(-5, 5, (8, 2, 3)).astype(np.float32)
    torques = rng.uniform(-0.2, 0.2, (8, 2, 3)).astype(np.float32)
    points = (np.asarray(jsim.state.body_pos)
              + rng.uniform(-0.05, 0.05, (8, 2, 3))).astype(np.float32)
    jsim.apply_body_forces(forces, torques, points)
    sim.apply_body_forces(forces, torques, points)

    for k in range(5):
        for _ in range(10):
            jsim.step()
            sim.step()
        got, want = to_numpy(sim.state), jsim.state._asdict()
        for f in ("root_pos", "root_quat", "root_linvel", "root_angvel",
                  "body_pos", "body_quat", "body_angvel"):
            _check(got[f], want[f], f"{f} after {10 * (k + 1)} steps")
    np.testing.assert_allclose(np.asarray(sim.root_state), np.asarray(jsim.root_state),
                               atol=1e-4 * max(float(np.abs(jsim.root_state).max()), 1))
    assert np.abs(sim.net_contact_force.numpy()).max() == 0.0


def test_reset_restores_initial_state_per_env():
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv

    env = BallsEnv(num_worlds=2, pyramids=3, device="cpu")
    sim = env.sim
    sim.rollout(5)
    moved = sim.state.root_pos.clone()
    sim.reset(np.array([True, False]))
    torch.testing.assert_close(sim.state.root_pos[0], sim.initial_state.root_pos[0])
    torch.testing.assert_close(sim.state.root_pos[1], moved[1])
    sim.reset()
    assert sim.state is sim.initial_state

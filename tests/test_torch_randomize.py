"""Port parity: domain randomization (randomize.py) against the JAX package.

The five cases of tests/test_randomize.py on the port (its generator draws
in place of the JAX key), and a replay: every draw of each JAX randomizer is
recorded (its `_u`, and the light's normal draw) and fed to the port's
randomizer through `_u` / `_n` in the same order, on the JAX package's
params carried across; the outputs agree at 1e-6.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_isaacgym_tpu  # noqa: F401  (CPU platform before jax init)
from test_isaacgym_tpu import randomize as jdr
from test_isaacgym_tpu.assets.primitives import create_sphere as jax_sphere
from test_isaacgym_tpu.core.config import SimParams as JaxSimParams
from test_isaacgym_tpu.core.scene import SceneBuilder as JaxBuilder
from test_isaacgym_tpu.core.sim import Simulator as JaxSimulator
from test_isaacgym_tpu_torch import randomize as dr
from test_isaacgym_tpu_torch.core.state import PhysParams, from_numpy, to_numpy

TOL = 1e-6


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_params(num_envs=4):
    b = JaxBuilder(JaxSimParams())
    ball = jax_sphere(0.1, density=100.0)
    for i in range(num_envs):
        b.create_env((-1, -1, 0), (1, 1, 1), 2)
        b.create_actor(i, ball, pos=(0, 0, 1), name="ball")
    return JaxSimulator(*b.finalize()).params


def _params(num_envs=4):
    """The port's params of the JAX package's 4-ball scene, carried across."""
    p = _jax_params(num_envs)
    return from_numpy({k: None if v is None else np.asarray(v) for k, v in p._asdict().items()},
                      PhysParams, "cpu")


def test_randomizers_change_only_their_fields():
    p = _params()
    p2 = dr.randomize_shape_friction(gen(0), p, 0.5, 1.5)
    assert not torch.allclose(p2.shape_friction, p.shape_friction)
    assert torch.equal(p2.body_mass, p.body_mass)
    f = p2.shape_friction.numpy()
    assert (f >= 0.5).all() and (f <= 1.5).all()
    assert len(np.unique(f.round(6))) > 1  # per env

    p3 = dr.randomize_body_mass(gen(0), p, 0.8, 1.2)
    ratio = (p3.body_inertia / p.body_inertia).reshape(4, -1).numpy()
    mass_ratio = (p3.body_mass / p.body_mass).numpy()
    np.testing.assert_allclose(ratio[:, 0], mass_ratio[:, 0], atol=1e-6)


def test_domain_randomizer_interval():
    p = _params()
    sched = dr.DomainRandomizer(interval=100, friction=(0.5, 1.5), mass_scale=None)
    at0 = sched.maybe(gen(1), p, torch.tensor(0))
    at50 = sched.maybe(gen(1), p, torch.tensor(50))
    assert not torch.allclose(at0.shape_friction, p.shape_friction)
    assert torch.equal(at50.shape_friction, p.shape_friction)
    assert sched.maybe(gen(1), p, 200).shape_friction.equal(at0.shape_friction)


def test_randomize_is_deterministic():
    p = _params()
    a = dr.DomainRandomizer().apply(gen(7), p)
    b = dr.DomainRandomizer().apply(gen(7), p)
    assert torch.equal(a.shape_friction, b.shape_friction)
    assert torch.equal(a.body_mass, b.body_mass)
    c = dr.DomainRandomizer().apply(gen(8), p)
    assert not torch.allclose(a.shape_friction, c.shape_friction)


def test_camera_and_light_randomizers():
    pos, tgt = dr.randomize_camera_pose(gen(2), 8, (0, 0, 0.5), device="cpu")
    assert pos.shape == (8, 3) and tgt.shape == (8, 3)
    assert (pos[:, 2] > tgt[:, 2]).all()
    color, ambient, d = dr.randomize_light(gen(2), device="cpu")
    assert abs(float(torch.linalg.vector_norm(d)) - 1) < 1e-5
    assert float(d[2]) < 0  # light from above
    assert ((color >= 0.4) & (color <= 1.0)).all() and ((ambient >= 0.1) & (ambient <= 0.5)).all()


def test_mass_matrix_tracks_randomized_mass():
    """After randomize_body_mass the mass matrix of the given params moves,
    and the default-params path reads sim.params at call time."""
    from test_isaacgym_tpu_torch.envs.franka import FrankaOscEnv

    env = FrankaOscEnv(num_envs=4, device="cpu")
    sim = env.sim
    mm_fn = sim.mass_matrix_fn("franka")
    m0 = mm_fn(sim.state, sim.params)
    p2 = dr.randomize_body_mass(gen(5), sim.params, 1.5, 2.5)
    m1 = mm_fn(sim.state, p2)
    assert float((m1 - m0).abs().max()) > 1e-3
    sim.params = p2
    m2 = sim.mass_matrix_fn("franka")(sim.state)
    assert float((m2 - m1).abs().max()) < 1e-6


# -- replay of the JAX package's draws -------------------------------------
@contextlib.contextmanager
def recording():
    """Record every draw the JAX randomizers make, in order."""
    draws = []
    u, normal = jdr._u, jax.random.normal

    def rec_u(key, shape, lo, hi):
        v = u(key, shape, lo, hi)
        draws.append(np.asarray(v))
        return v

    def rec_n(key, shape, *a, **kw):
        v = normal(key, shape, *a, **kw)
        draws.append(np.asarray(v))
        return v

    jdr._u, jax.random.normal = rec_u, rec_n
    try:
        yield draws
    finally:
        jdr._u, jax.random.normal = u, normal


@contextlib.contextmanager
def replaying(draws):
    """Feed recorded draws to the port's `_u` / `_n` in order."""
    queue = list(draws)

    def take(shape, device):
        v = queue.pop(0)
        assert v.shape == tuple(shape), (v.shape, shape)
        return torch.tensor(v, device=device)

    u, n = dr._u, dr._n
    dr._u = lambda gen, shape, lo, hi, device: take(shape, device)
    dr._n = lambda gen, shape, device: take(shape, device)
    try:
        yield
    finally:
        dr._u, dr._n = u, n
    assert not queue, f"{len(queue)} draws left"


def _close(got, want):
    if isinstance(want, tuple) and hasattr(want, "_fields"):
        for k, w in want._asdict().items():
            if w is not None:
                _close(getattr(got, k), w)
        return
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


SCHED = jdr.DomainRandomizer(restitution=(0.0, 0.7), gain_scale=(0.8, 1.2), gravity_scale=(0.9, 1.1))
PORT_SCHED = dr.DomainRandomizer(restitution=(0.0, 0.7), gain_scale=(0.8, 1.2),
                                 gravity_scale=(0.9, 1.1))
CASES = {
    "friction": (lambda k, p: jdr.randomize_shape_friction(k, p, 0.3, 1.7),
                 lambda g, p: dr.randomize_shape_friction(g, p, 0.3, 1.7)),
    "restitution": (jdr.randomize_restitution, dr.randomize_restitution),
    "body_mass": (jdr.randomize_body_mass, dr.randomize_body_mass),
    "dof_gains": (jdr.randomize_dof_gains, dr.randomize_dof_gains),
    "gravity": (jdr.randomize_gravity, dr.randomize_gravity),
    "shape_scale": (jdr.randomize_shape_scale, dr.randomize_shape_scale),
    "colors": (lambda k, p: jdr.randomize_colors(k, np.full((4, 3, 3), 0.7, np.float32)),
               lambda g, p: dr.randomize_colors(g, torch.full((4, 3, 3), 0.7))),
    "light": (lambda k, p: jdr.randomize_light(k), lambda g, p: dr.randomize_light(g, "cpu")),
    "camera_pose": (lambda k, p: jdr.randomize_camera_pose(k, 4, (0.1, 0.2, 0.4)),
                    lambda g, p: dr.randomize_camera_pose(g, 4, (0.1, 0.2, 0.4), device="cpu")),
    "apply": (SCHED.apply, PORT_SCHED.apply),
    "maybe_at_0": (lambda k, p: SCHED.maybe(k, p, jnp.asarray(0)),
                   lambda g, p: PORT_SCHED.maybe(g, p, torch.tensor(0))),
    "maybe_at_50": (lambda k, p: SCHED.maybe(k, p, jnp.asarray(50)),
                    lambda g, p: PORT_SCHED.maybe(g, p, torch.tensor(50))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_draws_match_jax(case):
    jax_fn, port_fn = CASES[case]
    jp = _jax_params()
    with recording() as draws:
        want = jax_fn(jax.random.PRNGKey(3), jp)
    assert draws
    p = from_numpy({k: None if v is None else np.asarray(v) for k, v in jp._asdict().items()},
                   PhysParams, "cpu")
    with replaying(draws):
        got = port_fn(gen(0), p)
    _close(got, want)
    if isinstance(want, tuple) and hasattr(want, "_fields"):
        # and nothing else moved
        for k, v in to_numpy(got).items():
            assert v is None or v.shape == np.asarray(getattr(want, k)).shape

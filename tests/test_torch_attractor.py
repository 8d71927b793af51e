"""Port parity: attractors (the implicit 6-DOF spring-damper of phase A)
against the JAX package.

The scene of examples/franka_attractor.py on the mesh-free Panda stand-in
(fixed base, gravity off, start pose [0, 0, 0, -1.2, 0, 1.5, 0, 0.02, 0.02],
an attractor on panda_hand at stiffness 5e5, damping 5e3), 4 envs, built
by the same SceneBuilder calls in both packages. The target sweeps the
example's path, y + 0.1 sin 1.5t and z + 0.1 cos 1.5t - 0.1, written into
the actions every step; 60 steps, dof_pos and the hand pose compared every
10 steps at the goldens' rule, 1e-4 * max(|ref|, 1). `lam` is not
compared: with gamma = 1/(h(hk + c)) small against J M^-1 J^T the 6x6
solve is ill-conditioned in float32 in both packages, and the impulses it
gives agree where they act, in the joint velocities. Variants: all axes;
all axes under a 40 N force limit; translation only (AXIS_TRANSLATION)
with an attachment offset. The Simulator's initial attractor actions are
the JAX Simulator's, and floating-base and free-body attractors raise the
JAX package's errors.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_isaacgym_tpu_torch.envs.franka import FRANKA_URDF, STANDIN_ROOT
from test_torch_kinematics import JAX, PORT, close

ATOL = 1e-4
N_ENVS, STEPS, EVERY = 4, 60, 10
START = np.array([0.0, 0.0, 0.0, -1.2, 0.0, 1.5, 0.0, 0.02, 0.02], np.float32)
AXIS_ALL, AXIS_TRANSLATION = 63, 7


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def attractor_sim(pkg, num_envs=N_ENVS, axes=AXIS_ALL, offset=(0.0, 0.0, 0.0)):
    """(sim, hand body) of the example's scene: each env's Panda stand-in
    at the start pose with an attractor on its hand."""
    cfg, sc, simm = (_mod(pkg, m) for m in ("core.config", "core.scene", "core.sim"))
    asset = _mod(pkg, "assets").load_urdf(STANDIN_ROOT, FRANKA_URDF, fix_base_link=True)
    asset.disable_gravity = True
    hand = asset.rigid_body_dict()["panda_hand"]
    b = sc.SceneBuilder(cfg.SimParams(dt=1 / 60, substeps=2))
    n_row = max(int(np.sqrt(num_envs)), 1)
    for e in range(num_envs):
        b.create_env((-1, -1, 0), (1, 1, 2), n_row)
        slot = b.create_actor(e, asset, name="franka", group=e, filter=1)
        b.add_attractor(e, slot, hand, offset_pos=offset, axes=axes,
                        stiffness=5e5, damping=5e3)
    if pkg == JAX:
        sim = simm.Simulator(*b.finalize())
    else:
        sim = simm.Simulator(*b.finalize("cpu"), device="cpu")
    sim.dof_state = np.stack([np.tile(START, num_envs), np.zeros(9 * num_envs)], -1).astype(
        np.float32)
    return sim, sim.scene.find_actor("franka").body_start + hand


def sweep_target(base_pos, t):
    """The example's target position at sim time t, (N, 3) numpy."""
    return base_pos + np.array(
        [0.0, 0.1 * np.sin(1.5 * t), 0.1 * np.cos(1.5 * t) - 0.1], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_case(axes, offset):
    sim, hand = attractor_sim(JAX, axes=axes, offset=offset)
    return sim, hand, jax.jit(sim.stepper.step)


def _run(pkg, axes, offset, force_limit):
    """Snapshots of (dof_pos, hand pos, hand quat) every EVERY steps."""
    if pkg == JAX:
        sim, hand, step = _jax_case(axes, offset)
        arr = jnp.asarray
    else:
        sim, hand = attractor_sim(PORT, axes=axes, offset=offset)
        step = sim.stepper.step
        arr = torch.as_tensor
    params = sim.params._replace(
        attractor_force_limit=arr(np.full((N_ENVS, 1), force_limit, np.float32)))
    s = sim.state
    base_pos = np.array(s.body_pos[:, hand])
    base_quat = arr(np.array(s.body_quat[:, hand])[:, None])
    snaps = []
    for k in range(STEPS + 1):
        if k % EVERY == 0:
            snaps.append([np.array(x) for x in (s.dof_pos, s.body_pos[:, hand],
                                                 s.body_quat[:, hand])])
        if k < STEPS:
            target = sweep_target(base_pos, k * sim.scene.sim_params.dt)
            actions = sim.actions._replace(attractor_target_pos=arr(target[:, None]),
                                           attractor_target_quat=base_quat)
            s = step(s, actions, params)
    return snaps


CASES = {
    "all_axes": (AXIS_ALL, (0.0, 0.0, 0.0), np.inf),
    "force_limit": (AXIS_ALL, (0.0, 0.0, 0.0), 40.0),
    "translation_offset": (AXIS_TRANSLATION, (0.0, 0.02, 0.1), np.inf),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_attractor_sweep_matches_jax(case):
    want, got = _run(JAX, *CASES[case]), _run(PORT, *CASES[case])
    for k, (w, g) in enumerate(zip(want, got)):
        for name, a, b in zip(("dof_pos", "hand_pos", "hand_quat"), g, w):
            close(a, b, f"{case} {name} after {EVERY * k} steps", tol=ATOL)
    # the hand moved with the target
    assert np.abs(want[-1][1] - want[0][1]).max() > 0.02


def test_initial_attractor_actions_match_jax():
    (jsim, _), (sim, _) = attractor_sim(JAX), attractor_sim(PORT)
    for f in ("attractor_target_pos", "attractor_target_quat", "attractor_enabled"):
        want = np.asarray(getattr(jsim.actions, f))
        got = getattr(sim.actions, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, f)
    assert sim.actions.attractor_enabled.all()


def _raise_message(pkg, build):
    cfg, sc = _mod(pkg, "core.config"), _mod(pkg, "core.scene")
    b = sc.SceneBuilder(cfg.SimParams())
    b.create_env((-1, -1, 0), (1, 1, 2), 1)
    build(pkg, b)
    scene = b.finalize()[0] if pkg == JAX else b.finalize("cpu")[0]
    step_mod = _mod(pkg, "physics.step")
    with pytest.raises(NotImplementedError) as info:
        step_mod.Stepper(scene) if pkg == JAX else step_mod.Stepper(scene, "cpu")
    return str(info.value)


def test_floating_base_and_free_body_attractors_raise_like_jax():
    from test_torch_kinematics import pendulum_asset

    def floating(pkg, b):
        slot = b.create_actor(0, pendulum_asset(pkg, fixed=False), pos=(0, 0, 1))
        b.add_attractor(0, slot, 1, stiffness=100.0)

    def free(pkg, b):
        slot = b.create_actor(0, _mod(pkg, "assets.primitives").create_box(0.1, 0.1, 0.1))
        b.add_attractor(0, slot, 0, stiffness=100.0)

    for build, want in ((floating, "floating-base"), (free, "only supported on articulated")):
        msg = _raise_message(PORT, build)
        assert msg == _raise_message(JAX, build) and want in msg

"""Port parity: the articulated step and the Simulator's articulation API.

Scenes built alike by both packages (the port's on the CPU) and stepped side
by side; tolerance: the goldens' rule, 1e-4 * max(|ref|, 1):
  * two copies a env of the branched chain of test_torch_kinematics.py
    (spherical joint, so synthetic links), fixed and floating base, with
    position, velocity and effort drives, saturating effort limits,
    armature, joint friction, joint limits, velocity limits, external link
    forces and torques and per-body gravity disable; set through the
    `dof_state` setter and the dof-target setters; plus `jacobian`,
    `jacobian_fn`, `body_jacobian_fn` and `mass_matrix` of the final state;
  * 64 free spheres on a ground beside a shape-free pendulum arm: the
    sphere-world contact solve with an articulation group in the scene;
  * a pendulum whose bob carries a sphere swinging into the ground: contact
    rows on an articulation link (LINK vs STATIC).
What the port does not run yet raises NotImplementedError: attractors.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

from test_isaacgym_tpu_torch.core.state import to_numpy
from test_torch_kinematics import JAX, PORT, chain_asset, close, pendulum_asset

ATOL = 1e-4
FIELDS = ("root_pos", "root_quat", "root_linvel", "root_angvel", "dof_pos", "dof_vel",
          "body_pos", "body_quat", "body_linvel", "body_angvel", "contact_force")


_check = functools.partial(close, tol=ATOL)


def _mods(pkg):
    return [importlib.import_module(f"{pkg}.{m}") for m in ("core.config", "core.scene", "core.sim")]


def _sim(pkg, build):
    config, scene, sim_mod = _mods(pkg)
    b = scene.SceneBuilder(config.SimParams(dt=1 / 60, substeps=2))
    build(pkg, b, config)
    if pkg == JAX:
        return sim_mod.Simulator(*b.finalize())
    return sim_mod.Simulator(*b.finalize("cpu"), device="cpu")


def _arms(fixed):
    def build(pkg, b, config):
        asset = chain_asset(pkg, fixed)
        for e in range(2):
            b.create_env((-1, -1, 0), (1, 1, 2), 2)
            b.create_actor(e, asset, pos=(0, 0, 1), name="arm0", group=e, filter=1)
            b.create_actor(e, asset, pos=(0.5, 0.1, 1.2), quat=(0, 0, 0.6, 0.8),
                           name="arm1", group=e, filter=1)
    return build


def _drive_setup(jsim, sim, seed):
    """The same dof properties, gravity switches, state and actions on
    both simulators."""
    rng = np.random.RandomState(seed)
    N, D = jsim.state.dof_pos.shape
    B = jsim.state.body_pos.shape[1]
    mode = rng.randint(0, 4, (N, D)).astype(np.int32)
    lower = rng.uniform(-0.6, -0.1, (N, D)).astype(np.float32)
    params = dict(
        dof_drive_mode=mode,
        dof_stiffness=rng.uniform(10, 200, (N, D)).astype(np.float32),
        dof_damping=rng.uniform(0.5, 5, (N, D)).astype(np.float32),
        dof_armature=rng.uniform(0, 0.05, (N, D)).astype(np.float32),
        dof_friction=rng.uniform(0, 0.5, (N, D)).astype(np.float32),
        dof_max_effort=rng.uniform(2, 30, (N, D)).astype(np.float32),
        dof_max_velocity=rng.uniform(1, 5, (N, D)).astype(np.float32),
        dof_has_limits=rng.rand(N, D) < 0.5,
        dof_lower=lower,
        dof_upper=(lower + rng.uniform(0.3, 1.0, (N, D))).astype(np.float32),
        body_disable_gravity=rng.rand(N, B) < 0.3,
    )
    jsim.params = jsim.params._replace(**params)
    sim.params = sim.params._replace(**{k: torch.as_tensor(v) for k, v in params.items()})
    dof_state = np.stack([rng.uniform(-0.3, 0.3, (N, D)), rng.normal(size=(N, D))], -1)
    dof_state = dof_state.reshape(N * D, 2).astype(np.float32)
    actions = dict(
        set_dof_position_targets=rng.uniform(-0.5, 0.5, (N, D)),
        set_dof_velocity_targets=rng.normal(size=(N, D)),
        set_dof_actuation_forces=rng.uniform(-40, 40, (N, D)),
    )
    forces = (rng.normal(size=(N, B, 3)) * 3).astype(np.float32)
    torques = (rng.normal(size=(N, B, 3)) * 0.3).astype(np.float32)
    for s in (jsim, sim):
        s.dof_state = dof_state
        for name, a in actions.items():
            getattr(s, name)(a.astype(np.float32))
        s.apply_body_forces(forces, torques)


@pytest.mark.parametrize("fixed", [True, False])
def test_articulated_chain_steps_like_jax(fixed):
    jsim, sim = _sim(JAX, _arms(fixed)), _sim(PORT, _arms(fixed))
    assert not sim.stepper.groups[0].all_real  # the spherical joint's synthetic links
    _drive_setup(jsim, sim, seed=3 + fixed)
    _check(sim.dof_state.numpy(), jsim.dof_state, "dof_state after the setter")
    for k in range(4):
        for _ in range(5):
            jsim.step()
            sim.step()
        got, want = to_numpy(sim.state), jsim.state._asdict()
        for f in FIELDS:
            _check(got[f], want[f], f"{f} after {5 * (k + 1)} steps")
    _check(sim.jacobian("arm1").numpy(), jsim.jacobian("arm1"), "jacobian")
    _check(sim.jacobian_fn("arm0")(sim.state).numpy(), jsim.jacobian_fn("arm0")(jsim.state),
           "jacobian_fn")
    _check(sim.body_jacobian_fn("arm1", "l4")(sim.state).numpy(),
           jsim.body_jacobian_fn("arm1", "l4")(jsim.state), "body_jacobian_fn")
    _check(sim.mass_matrix("arm0").numpy(), jsim.mass_matrix("arm0"), "mass_matrix")


def _balls_beside_arm(pkg, b, config):
    prim = importlib.import_module(f"{pkg}.assets.primitives")
    b.add_ground(config.PlaneParams())
    b.create_env((-2, -2, 0), (2, 2, 2), 1)
    b.create_actor(0, pendulum_asset(pkg, fixed=True), pos=(0, 0, 1.5), name="arm")
    ball = prim.create_sphere(0.1, density=500.0)
    for i in range(64):
        x, y = (i % 8 - 3.5) * 0.22, (i // 8 - 3.5) * 0.22
        b.create_actor(0, ball, pos=(x, y, 0.3 + 0.05 * (i % 3)), name=f"ball{i}")


def test_sphere_world_beside_an_arm_steps_like_jax():
    jsim, sim = _sim(JAX, _balls_beside_arm), _sim(PORT, _balls_beside_arm)
    assert sim.stepper.contact.sphere_world is not None and sim.stepper.groups
    assert sim.stepper.contact.enabled and not sim.stepper.contact.num_contacts
    dof_state = np.array([[0.8, 0.0]], np.float32)
    jsim.dof_state = dof_state
    sim.dof_state = dof_state
    for k in range(3):
        for _ in range(10):
            jsim.step()
            sim.step()
        got, want = to_numpy(sim.state), jsim.state._asdict()
        for f in FIELDS:
            _check(got[f], want[f], f"{f} after {10 * (k + 1)} steps")
    assert float(sim.state.contact_force[..., 2].max()) > 0  # the balls rest on the ground


def test_link_contact_rows_raise():
    """An arm whose link has a collision shape over a ground plane gives
    contact rows on its link, which the port now steps like the JAX package
    (the name is the test's from before link contacts were ported): the
    bob, raised 0.8 rad, swings down through the lowest point, where its
    sphere reaches 5 cm into the ground."""
    def build(pkg, b, config):
        t = importlib.import_module(f"{pkg}.assets.types")
        asset = pendulum_asset(pkg)
        asset.links[1].geoms.append(t.GeomSpec(t.GEOM_SPHERE, (0.1,), (0, 0, -1.0)))
        b.add_ground(config.PlaneParams())
        b.create_env((-1, -1, 0), (1, 1, 2), 1)
        b.create_actor(0, asset, pos=(0, 0, 1.05), name="arm")

    jsim, sim = _sim(JAX, build), _sim(PORT, build)
    assert sim.stepper.contact.any_link and jsim.stepper.contact.any_link
    dof_state = np.array([[0.8, 0.0]], np.float32)
    jsim.dof_state = dof_state
    sim.dof_state = dof_state
    touched = 0.0
    for k in range(3):
        for _ in range(20):
            jsim.step()
            sim.step()
            touched = max(touched, float(np.abs(np.asarray(jsim.state.contact_force)).max()))
        got, want = to_numpy(sim.state), jsim.state._asdict()
        for f in FIELDS:
            _check(got[f], want[f], f"{f} after {20 * (k + 1)} steps")
    assert touched > 0  # the sphere met the ground


def test_attractors_raise():
    def build(pkg, b, config):
        b.create_env((-1, -1, 0), (1, 1, 2), 1)
        b.create_actor(0, pendulum_asset(pkg), name="arm")
        b.add_attractor(0, 0, 1, stiffness=100.0, damping=10.0)

    with pytest.raises(NotImplementedError, match="attractor"):
        _sim(PORT, build)

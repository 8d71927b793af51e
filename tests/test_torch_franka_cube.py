"""Port parity: FrankaCubeEnv (the grasp FSM, IK and OSC control, two-way
finger-cube contact) against the JAX package.

4 envs of each controller on the Panda stand-in with collision boxes on the
hand and fingers (test_isaacgym_tpu_torch/assets/data/panda_standin,
franka_panda_boxes.urdf), built by each package: the JAX env loads the same
file through its module's ASSET_ROOT / FRANKA_URDF. The port's build must
give the JAX env's contact table, state and params; then both run 60
control+physics steps, compared every 10 steps on box_pos, dof_pos and
dof_vel, and at every step on `gripped`, at the goldens' rule,
1e-4 * max(|ref|, 1). The JAX env runs its control op by op and its
physics step jitted (its Jacobi scan traced rolled,
tests/test_torch_contacts.py::rolled_scan), in a Python loop; both
controllers' scenes are the same, so one compiled physics step serves
both.

The committed golden franka_cube_standin.npz holds the JAX env's box_pos
and dof_pos at steps 0, 10, ..., 60 of each controller; the JAX package and
the port must both reproduce it on the CPU, and chip_smoke.py holds the
card to it. Regenerate it, and print the JAX env's grip and lift shares
that chip_smoke.py reports against, with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_franka_cube.py

With `--divergence` it prints instead where the grasp parts (4 envs of seed
42, 150 steps): the JAX env run op by op (jax.disable_jit) and the port,
each against the JAX env with its physics step jitted, at every step.

(XLA_FLAGS=--xla_cpu_use_fusion_emitters=false as tests/conftest.py sets
it, if XLA:CPU hangs compiling the step; ~7 minutes, most of it the
4096-env run). Those shares (the JAX env on the CPU, OSC, 100 steps, the
4096 envs of seed 42), where an env grips when `gripped` holds at some step
and lifts when it grips with the cube above the table top + 0.1 m at some
step: grip share 1.000000, lift share 0.997803 (the first 64 envs: 1.000000
and 1.000000). The same run's lowest cube bottom after 100 steps is
0.376557 m, 2.3 cm into the 0.4 m table top (env 1687: the open hand comes
down on the cube it dropped and presses it into the table), and 0.371540 m
at its deepest; chip_smoke.py holds the card to these.
"""
import contextlib
import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

import test_isaacgym_tpu.envs.franka_cube as jfc
from test_isaacgym_tpu_torch.core.state import to_numpy
from test_isaacgym_tpu_torch.envs import franka_cube as tfc
from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT
from test_torch_contacts import rolled_scan
from test_torch_kinematics import close

GOLDEN = os.path.join(STANDIN_ROOT, "franka_cube_standin.npz")
ATOL = 1e-4
N_ENVS, EVERY, STEPS = 4, 10, 60
CONTROLLERS = ("ik", "osc")
# grip and lift shares and the lowest cube of the JAX env (see the
# docstring), printed by this module run as a script
SHARE_ENVS, SHARE_STEPS = 4096, 100

_check = functools.partial(close, tol=ATOL)  # the goldens' rule


@contextlib.contextmanager
def jax_standin():
    """The JAX env's module constants pointed at the port's stand-in."""
    saved = jfc.ASSET_ROOT, jfc.FRANKA_URDF
    jfc.ASSET_ROOT, jfc.FRANKA_URDF = STANDIN_ROOT, tfc.FRANKA_URDF
    try:
        yield
    finally:
        jfc.ASSET_ROOT, jfc.FRANKA_URDF = saved


def jax_env(controller, num_envs=N_ENVS):
    with jax_standin():
        return jfc.FrankaCubeEnv(num_envs=num_envs, controller=controller)


def _snap(st, box_slot):
    return dict(box_pos=np.array(st.root_pos[:, box_slot]), dof_pos=np.array(st.dof_pos),
                dof_vel=np.array(st.dof_vel))


@functools.lru_cache(maxsize=None)
def _jax_physics(num_envs):
    """The JAX Stepper.step of the num_envs-env scene, jitted: a function of
    (state, actions, params) that both controllers' envs share."""
    return jax.jit(jax_env("ik", num_envs).sim.stepper.step)


def jax_run(controller, num_envs=N_ENVS, steps=STEPS):
    """The JAX env's snapshots every EVERY steps (dict of (steps/EVERY + 1,
    N, .) arrays), its per-step `gripped` and box z ((steps, N) each), and
    the env."""
    env = jax_env(controller, num_envs)
    env.sim.stepper.step = _jax_physics(num_envs)  # step_fn's physics
    st, snaps, gripped, box_z = env.init_state, [], [], []
    with rolled_scan():
        for k in range(steps + 1):
            if k % EVERY == 0:
                snaps.append(_snap(st.sim, env.box_slot))
            if k < steps:
                st, (g, z) = env.step_fn(st)
                gripped.append(np.array(g))
                box_z.append(np.array(z))
    return ({key: np.stack([s[key] for s in snaps]) for key in snaps[0]},
            np.stack(gripped), np.stack(box_z), env)


def port_run(env):
    run = env.rollout_fn(EVERY)
    st, snaps, gripped = env.init_state, [], []
    for k in range(STEPS // EVERY + 1):
        snaps.append({key: v for key, v in to_numpy(st.sim).items()
                      if key in ("dof_pos", "dof_vel")})
        snaps[-1]["box_pos"] = st.sim.root_pos[:, env.box_slot].numpy()
        if k < STEPS // EVERY:
            st, (g, _) = run(st)
            gripped.append(g.numpy())
    return {key: np.stack([s[key] for s in snaps]) for key in snaps[0]}, np.concatenate(gripped)


@functools.lru_cache(maxsize=None)
def _jax(controller):
    return jax_run(controller)


@functools.lru_cache(maxsize=None)
def _port(controller):
    env = tfc.FrankaCubeEnv(num_envs=N_ENVS, controller=controller, device="cpu")
    return env, port_run(env)


@pytest.mark.parametrize("controller", CONTROLLERS)
def test_port_scene_build_matches_jax(controller):
    """The same contact table (151 rows an env: 32 box-plane corners of the
    hand, two fingers and cube; 17 box-box rows for each hand/finger box
    against the cube and the table, and for the cube against the table),
    initial state and params."""
    jenv, env = jax_env(controller), _port(controller)[0]
    jc, c = jenv.sim.stepper.contact, env.sim.stepper.contact
    assert c.num_contacts == jc.num_contacts == 151
    kinds, counts = np.unique(c.job.kind, return_counts=True)
    assert dict(zip(kinds.tolist(), counts.tolist())) == {2: 32, 8: 7 * 16, 9: 7}
    for side in ("a", "b"):
        for f, x, y in zip(c.job.a._fields, getattr(c.job, side), getattr(jc.job, side)):
            np.testing.assert_array_equal(x, y, f"job.{side}.{f}")
    for f in ("kind", "shape_a", "shape_b", "slot"):
        np.testing.assert_array_equal(getattr(c.job, f), getattr(jc.job, f), f)
    for k, want in jenv.sim.initial_state._asdict().items():
        if want is None:
            assert getattr(env.sim.initial_state, k) is None, k
        else:
            _check(getattr(env.sim.initial_state, k).numpy(), np.asarray(want), f"state.{k}")
    for k, want in jenv.sim.params._asdict().items():
        if want is not None:
            np.testing.assert_array_equal(getattr(env.sim.params, k).numpy(), np.asarray(want), k)
    assert (env.hand_body, env.box_slot, env.grasp_offset) == (
        jenv.hand_body, jenv.box_slot, jenv.grasp_offset)
    _check(env.init_hand_pos.numpy(), jenv.init_hand_pos, "init_hand_pos")


@pytest.mark.parametrize("controller", CONTROLLERS)
def test_rollout_matches_jax(controller):
    """60 steps of the port's own build against the JAX env's: the cube
    pose, the dofs and `gripped` at every step (every OSC env grips in this
    window; no IK env does yet)."""
    want, want_gripped, _, _ = _jax(controller)
    got, got_gripped = _port(controller)[1]
    for k in ("box_pos", "dof_pos", "dof_vel"):
        for i in range(STEPS // EVERY + 1):
            _check(got[k][i], want[k][i], f"{controller} {k} at step {EVERY * i}")
    np.testing.assert_array_equal(got_gripped, want_gripped)
    if controller == "osc":
        assert want_gripped[-1].all(), "an OSC env does not grip by the window's end"


@pytest.mark.parametrize("controller", CONTROLLERS)
def test_golden_reproduced_by_jax_and_port(controller):
    """The committed golden cannot go stale unnoticed: the JAX package
    reproduces it, and so does the port from its own scene build."""
    golden = np.load(GOLDEN)
    want, got = _jax(controller)[0], _port(controller)[1][0]
    for k in ("box_pos", "dof_pos"):
        ref = golden[f"{controller}_{k}"]
        assert ref.shape == want[k].shape, (k, ref.shape)
        for i in range(STEPS // EVERY + 1):
            _check(want[k][i], ref[i], f"jax {controller} {k} at step {EVERY * i}")
            _check(got[k][i], ref[i], f"port {controller} {k} at step {EVERY * i}")


def test_default_device_is_cuda():
    """FrankaCubeEnv runs on CUDA unless asked for the CPU; without a card
    it raises instead of falling back."""
    fields = {f.name: f.default for f in dataclasses.fields(tfc.FrankaCubeEnv)}
    assert fields["device"] == "cuda"
    if torch.cuda.is_available():
        assert tfc.FrankaCubeEnv(num_envs=1).sim.state.dof_pos.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tfc.FrankaCubeEnv(num_envs=1)


def shares(gripped, box_z):
    """(grip share, lift share) of a run's per-step (T, N) `gripped` and box
    z: an env grips when gripped at some step, and lifts when gripped with
    the cube above the table top + 0.1 m at some step."""
    lifted = gripped & (box_z > tfc.TABLE_DIMS[2] + 0.1)
    return float(gripped.any(0).mean()), float(lifted.any(0).mean())


def divergence(controller, steps=150):
    """Where the grasp parts, 4 envs of seed 42: at each step the largest
    rel_err (|x - ref| / max(|ref|, 1) over box_pos, dof_pos, dof_vel) of
    the JAX env run op by op (jax.disable_jit) and of the port against the
    JAX env with its physics step jitted. Prints the first step at which
    each exceeds the goldens' rule, ATOL."""
    env = jax_env(controller)
    eager = jax_env(controller)
    env.sim.stepper.step = _jax_physics(N_ENVS)
    port = tfc.FrankaCubeEnv(num_envs=N_ENVS, controller=controller, device="cpu")
    one = port.rollout_fn(1)
    a, b, c = env.init_state, eager.init_state, port.init_state
    first = {}

    def err(snap, ref):
        return max(float(np.abs(snap[k] - ref[k]).max()) / max(float(np.abs(ref[k]).max()), 1.0)
                   for k in ref)

    with rolled_scan():
        for k in range(1, steps + 1):
            a = env.step_fn(a)[0]
            with jax.disable_jit():
                b = eager.step_fn(b)[0]
            c = one(c)[0]
            ref = _snap(a.sim, env.box_slot)
            port_snap = {key: v for key, v in to_numpy(c.sim).items() if key in ("dof_pos", "dof_vel")}
            port_snap["box_pos"] = c.sim.root_pos[:, port.box_slot].numpy()
            e_self, e_port = err(_snap(b.sim, env.box_slot), ref), err(port_snap, ref)
            for name, e in (("JAX op by op", e_self), ("port", e_port)):
                if e > ATOL and name not in first:
                    first[name] = k
            print(f"{controller} step {k}: JAX op by op {e_self:.3e}, port {e_port:.3e} "
                  "(of the jitted JAX env)", flush=True)
    print(f"{controller}: first step over {ATOL}: {first or 'none'} in {steps} steps")


if __name__ == "__main__" and "--divergence" in sys.argv:
    for ctrl in ("osc", "ik"):
        divergence(ctrl)
elif __name__ == "__main__":
    out = {}
    for ctrl in CONTROLLERS:
        snaps = jax_run(ctrl)[0]
        for k in ("box_pos", "dof_pos"):
            out[f"{ctrl}_{k}"] = snaps[k]
    np.savez(GOLDEN, **out)
    print(f"wrote {GOLDEN}: " + ", ".join(f"{k} {v.shape}" for k, v in out.items()))
    snaps, g, z, _ = jax_run("osc", SHARE_ENVS, SHARE_STEPS)
    grip, lift = shares(g, z)
    grip64, lift64 = shares(g[:, :64], z[:, :64])
    end = snaps["box_pos"][-1, :, 2] - 0.5 * tfc.BOX_SIZE
    deepest = min(float(end.min()), float(z.min()) - 0.5 * tfc.BOX_SIZE)
    print(f"JAX env (CPU), osc, {SHARE_ENVS} envs, {SHARE_STEPS} steps: grip share "
          f"{grip:.6f}, lift share {lift:.6f} (the first 64 envs: {grip64:.6f}, "
          f"{lift64:.6f}); lowest cube bottom at the end {end.min():.6f} m (env "
          f"{end.argmin()}), over the run {deepest:.6f} m")


def test_rollout_is_the_jax_method():
    """FrankaCubeEnv.rollout(num_steps, state=None) has the JAX env's name,
    signature and stacked outputs (rollout_fn stays as its alias), and
    step_fn takes the JAX scan's trailing argument. The JAX side is its
    step_fn loop, the body its rollout scans (the scan compiled whole takes
    about a minute on the CPU)."""
    import inspect

    for name in ("rollout", "step_fn"):
        assert (list(inspect.signature(getattr(tfc.FrankaCubeEnv, name)).parameters)
                == list(inspect.signature(getattr(jfc.FrankaCubeEnv, name)).parameters)), name
    want, want_gripped, want_z, _ = _jax("osc")
    env = tfc.FrankaCubeEnv(num_envs=N_ENVS, controller="osc", device="cpu")
    st, (gripped, box_z) = env.rollout(EVERY)
    assert gripped.shape == box_z.shape == (EVERY, N_ENVS)
    np.testing.assert_array_equal(gripped.numpy(), want_gripped[:EVERY])
    _check(box_z.numpy(), want_z[:EVERY], "box z")
    _check(st.sim.root_pos[:, env.box_slot].numpy(), want["box_pos"][1], "box_pos at step 10")
    _check(st.sim.dof_pos.numpy(), want["dof_pos"][1], "dof_pos at step 10")
    alias = env.rollout_fn(EVERY)(env.init_state)
    assert torch.equal(alias[0].sim.dof_pos, st.sim.dof_pos)
    one, scanned = env.step_fn(env.init_state), env.step_fn(env.init_state, None)
    assert torch.equal(one[0].sim.dof_pos, scanned[0].sim.dof_pos)

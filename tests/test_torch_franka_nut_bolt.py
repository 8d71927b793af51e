"""Port parity: FrankaNutBoltEnv (the 11-state screw FSM, damped IK, SDF
thread contact in both families) against the JAX package.

2 envs of each start (the nut on the table; `start_on_bolt`, the nut
threaded at the bolt's top and the FSM in LOOSEN) on the committed
stand-ins: the Panda with collision boxes and the code-built nut. The JAX
env reads both from its module's ASSET_ROOT, pointed here at a temporary
root that holds copies: the boxes Panda as
urdf/franka_description/robots/franka_panda.urdf and the nut stand-in.
The port's build must give the JAX env's contact table (nut-vs-bolt rows
in both SDF directions: the nut's probes against the bolt's closed form,
the bolt's against the nut's voxel grid), state and params. Then both run,
the JAX env's physics step jitted (its Jacobi scan traced rolled) and its
control op by op: the nut pose, dof_pos and dof_vel at every step at the
goldens' rule, 1e-4 * max(|ref|, 1), and the FSM state sequence exactly,
up to the step where the JAX env parts from itself, jitted against op by
op (FSM thresholds such as err < 1e-2 can flip once trajectories part),
stored in the golden as self_agree.

Both packages' SDF caches point at a temporary directory for this module.

Run as a script, this regenerates franka_nut_bolt_standin.npz: per start,
the JAX env's self-agreement horizon and its trajectory to that step; and
the numbers chip_smoke.py bounds the card by: the JAX env's share of envs
in each FSM state and its mean nut descent after BIG_STEPS steps of 512
envs from the bolt start (the reference example's width):
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_franka_nut_bolt.py
"""
import contextlib
import dataclasses
import functools
import os
import shutil
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_isaacgym_tpu.assets.sdf as jsdf  # noqa: E402
import test_isaacgym_tpu.envs.franka_nut_bolt as jfnb  # noqa: E402
import test_isaacgym_tpu_torch.assets.sdf as tsdf  # noqa: E402
from test_isaacgym_tpu_torch.envs import franka_nut_bolt as tfnb  # noqa: E402
from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT  # noqa: E402
from test_isaacgym_tpu_torch.envs.nut_bolt import NUT_STANDIN_ROOT, NUT_URDF  # noqa: E402
from test_torch_contacts import rolled_scan  # noqa: E402
from test_torch_kinematics import close  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-4
N_ENVS = 2
STARTS = ("table", "bolt")
MAX_HORIZON = 20  # steps held here at most (chip_smoke.py holds the golden's all)
GOLDEN = os.path.join(NUT_STANDIN_ROOT, "..", "franka_nut_bolt_standin.npz")
BIG_ENVS, BIG_STEPS = 512, 150  # the chip's franka_nut_bolt512 run
SELF_AGREE_STEPS = 30  # steps the script compares jitted and op by op
SNAP = ("nut_pos", "dof_pos", "dof_vel")


@contextlib.contextmanager
def jax_standin():
    """The JAX env's ASSET_ROOT pointed at a temporary root holding copies
    of the boxes Panda (under the name the JAX env loads) and the nut."""
    root = tempfile.mkdtemp()
    robots = os.path.join(root, "urdf", "franka_description", "robots")
    os.makedirs(robots)
    shutil.copy(os.path.join(STANDIN_ROOT, tfnb.FRANKA_URDF),
                os.path.join(robots, "franka_panda.urdf"))
    shutil.copytree(os.path.join(NUT_STANDIN_ROOT, os.path.dirname(NUT_URDF)),
                    os.path.join(root, os.path.dirname(NUT_URDF)))
    saved = jfnb.ASSET_ROOT
    jfnb.ASSET_ROOT = root
    try:
        yield
    finally:
        jfnb.ASSET_ROOT = saved
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def private_caches(d):
    saved = jsdf._CACHE_DIR, tsdf._CACHE_DIR
    jsdf._CACHE_DIR, tsdf._CACHE_DIR = os.path.join(d, "jax"), os.path.join(d, "torch")
    try:
        yield
    finally:
        jsdf._CACHE_DIR, tsdf._CACHE_DIR = saved


@pytest.fixture(scope="module", autouse=True)
def grid_caches(tmp_path_factory):
    with private_caches(str(tmp_path_factory.mktemp("sdf_cache"))):
        yield


def jax_env(start, num_envs=N_ENVS):
    with jax_standin():
        return jfnb.FrankaNutBoltEnv(num_envs=num_envs, start_on_bolt=start == "bolt")


def port_env(start, num_envs=N_ENVS):
    return tfnb.FrankaNutBoltEnv(num_envs=num_envs, start_on_bolt=start == "bolt", device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_physics(num_envs):
    """The JAX Stepper.step of the scene, jitted: both starts' scenes have
    the same structure (their poses are state), so one compile serves both."""
    return jax.jit(jax_env("bolt", num_envs).sim.stepper.step)


def _snap(st, nut_slot):
    return {"nut_pos": np.array(st.root_pos[:, nut_slot]), "dof_pos": np.array(st.dof_pos),
            "dof_vel": np.array(st.dof_vel)}


def jax_run(start, steps, num_envs=N_ENVS):
    """The JAX env's snapshots at steps 0..steps (dict of (steps + 1, N, .)
    arrays) and FSM states before each step ((steps, N))."""
    env = jax_env(start, num_envs)
    env.sim.stepper.step = _jax_physics(num_envs)
    st, snaps, fsm = env.init_state, [], []
    with rolled_scan():
        for k in range(steps + 1):
            snaps.append(_snap(st.sim, env.nut_slot))
            if k < steps:
                st, (f, _) = env.step_fn(st)
                fsm.append(np.array(f))
    return ({k: np.stack([s[k] for s in snaps]) for k in SNAP},
            np.asarray(fsm, np.int32).reshape(steps, num_envs))


def port_run(env, steps):
    st, snaps, fsm = env.init_state, [], []
    for k in range(steps + 1):
        snaps.append(_snap(st.sim, env.nut_slot))
        if k < steps:
            st, (f, _) = env.step_fn(st)
            fsm.append(f.numpy())
    return {k: np.stack([s[k] for s in snaps]) for k in SNAP}, np.stack(fsm)


def horizon(start):
    return min(int(np.load(GOLDEN)[f"{start}_self_agree"]), MAX_HORIZON)


@functools.lru_cache(maxsize=None)
def _runs(start):
    steps = horizon(start)
    env = port_env(start)
    return jax_run(start, steps), port_run(env, steps), env


@pytest.mark.parametrize("start", STARTS)
def test_scene_build_matches_jax(start):
    jenv, env = jax_env(start), port_env(start)
    jc, c = jenv.sim.stepper.contact, env.sim.stepper.contact
    assert c.num_contacts == jc.num_contacts
    for f in ("kind", "shape_a", "shape_b", "slot"):
        np.testing.assert_array_equal(getattr(c.job, f), getattr(jc.job, f), f)
    # the nut-bolt pair in both directions: one closed form, one voxel grid
    assert (c.job.kind == 17).sum() == 2 * 16  # rows of one env
    assert len(c.sdf_voxel_q) == 1 and len(c.sdf_analytic_groups) == 1
    np.testing.assert_array_equal(c.sdf_data, np.asarray(jc.sdf_data))
    for k, want in jenv.sim.initial_state._asdict().items():
        if want is not None:
            close(getattr(env.sim.initial_state, k).numpy(), np.asarray(want), f"state.{k}",
                  tol=ATOL)
    for k, want in jenv.sim.params._asdict().items():
        if want is not None:
            np.testing.assert_array_equal(getattr(env.sim.params, k).numpy(), np.asarray(want), k)
    for a, b in zip(env.init_state[1:], jenv.init_state[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (env.nut_slot, env.bolt_slot, env.hand_body, env.dof0) == (
        jenv.nut_slot, jenv.bolt_slot, jenv.hand_body, jenv.dof0)
    for name in ("grip_off", "above_off", "lift_off", "on_bolt_off", "above_bolt_off",
                 "nut_grab_q"):
        close(getattr(env, name).numpy(), np.asarray(getattr(jenv, name)), name, tol=1e-6)


@pytest.mark.parametrize("start", STARTS)
def test_rollout_matches_jax(start):
    """Every step up to the JAX env's self-agreement horizon: the nut pose,
    the dofs and the FSM states."""
    (want, want_fsm), (got, got_fsm), _ = _runs(start)
    assert len(want_fsm) >= 10, "the horizon is too short to hold anything"
    for k in SNAP:
        for i in range(len(want[k])):
            close(got[k][i], want[k][i], f"{start} {k} at step {i}", tol=ATOL)
    np.testing.assert_array_equal(got_fsm, want_fsm)


@pytest.mark.parametrize("start", STARTS)
def test_golden_reproduced_by_port(start):
    golden = np.load(GOLDEN)
    (_, _), (got, got_fsm), _ = _runs(start)
    n = len(got_fsm)
    for k in SNAP:
        ref = golden[f"{start}_{k}"][:n + 1]
        for i in range(n + 1):
            close(got[k][i], ref[i], f"port {start} {k} at step {i}", tol=ATOL)
    np.testing.assert_array_equal(got_fsm, golden[f"{start}_fsm"][:n])


def test_default_device_is_cuda():
    fields = {f.name: f.default for f in dataclasses.fields(tfnb.FrankaNutBoltEnv)}
    assert fields["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tfnb.FrankaNutBoltEnv(num_envs=1)


def test_screw_state_carries_across():
    """from_numpy builds the port's ScrewState from the JAX env's."""
    from test_isaacgym_tpu_torch.core.state import SimState, from_numpy

    jenv = jax_env("bolt")
    js = jenv.init_state
    sim = from_numpy({k: None if v is None else np.asarray(v)
                      for k, v in js.sim._asdict().items()}, SimState, "cpu")
    st = from_numpy({"sim": sim, "fsm": np.asarray(js.fsm),
                     "screw_angle": np.asarray(js.screw_angle)}, tfnb.ScrewState, "cpu")
    assert st.fsm.dtype == torch.int32 and st.screw_angle.dtype == torch.float32
    assert st.fsm.tolist() == [tfnb.S_LOOSEN] * N_ENVS
    with pytest.raises(TypeError):
        from_numpy({"sim": js.sim, "fsm": np.asarray(js.fsm)}, tfnb.ScrewState, "cpu")


# ---------------------------------------------------------------------------
# the golden, run as a script

def self_agreement(start):
    """The last step up to which the JAX env with its physics jitted and the
    JAX env run op by op (jax.disable_jit) agree within the goldens' rule,
    with equal FSM states."""
    a_env, b_env = jax_env(start), jax_env(start)
    a_env.sim.stepper.step = _jax_physics(N_ENVS)
    a, b = a_env.init_state, b_env.init_state
    for k in range(1, SELF_AGREE_STEPS + 1):
        a = a_env.step_fn(a)[0]
        with jax.disable_jit():
            b = b_env.step_fn(b)[0]
        sa, sb = _snap(a.sim, a_env.nut_slot), _snap(b.sim, b_env.nut_slot)
        err = max(float(np.abs(sb[f] - sa[f]).max()) / max(float(np.abs(sa[f]).max()), 1.0)
                  for f in SNAP)
        same = np.array_equal(np.asarray(a.fsm), np.asarray(b.fsm))
        print(f"  {start} step {k}: jitted vs op by op {err:.3e}, fsm {np.asarray(a.fsm)}"
              f"{'' if same else ' DIFFER'}", flush=True)
        if err > ATOL or not same:
            return k - 1
    return SELF_AGREE_STEPS


def main():
    out = {}
    with rolled_scan():
        for start in STARTS:
            agree = self_agreement(start)
            snaps, fsm = jax_run(start, agree)
            print(f"{start}: the JAX env agrees with itself for {agree} steps", flush=True)
            out[f"{start}_self_agree"] = agree
            for k in SNAP:
                out[f"{start}_{k}"] = snaps[k]
            out[f"{start}_fsm"] = fsm
        env = jax_env("bolt", BIG_ENVS)
        roll = jax.jit(lambda s: env.rollout(10, s))
        st = env.init_state
        z0 = np.asarray(env.nut_height_now(st))
        for _ in range(BIG_STEPS // 10):
            st, _ = roll(st)
    fsm = np.asarray(st.fsm)
    shares = np.bincount(fsm, minlength=11) / BIG_ENVS
    descent = float((np.asarray(env.nut_height_now(st)) - z0).mean())
    print(f"JAX env (CPU), bolt start, {BIG_ENVS} envs, {BIG_STEPS} steps: FSM shares "
          f"{np.round(shares, 6).tolist()}, mean nut descent {descent:.6e} m")
    np.savez_compressed(os.path.abspath(GOLDEN), **out, jax_shares=shares,
                        jax_descent=descent, big_envs=BIG_ENVS, big_steps=BIG_STEPS)
    print(f"wrote {os.path.abspath(GOLDEN)}")


if __name__ == "__main__":
    main()


def test_step_fn_takes_the_scan_argument():
    """step_fn(state, _=None): the JAX env's trailing scan argument
    (envs/franka_nut_bolt.py:286); one step so is the JAX env's first."""
    import inspect

    assert (list(inspect.signature(tfnb.FrankaNutBoltEnv.step_fn).parameters)
            == list(inspect.signature(jfnb.FrankaNutBoltEnv.step_fn).parameters))
    (want, want_fsm), _, env = _runs("bolt")
    st, (fsm, _) = env.step_fn(env.init_state, None)
    np.testing.assert_array_equal(fsm.numpy(), want_fsm[0])
    close(st.sim.dof_pos.numpy(), want["dof_pos"][1], "dof_pos after one step", tol=ATOL)
    close(st.sim.root_pos[:, env.nut_slot].numpy(), want["nut_pos"][1], "nut_pos", tol=ATOL)

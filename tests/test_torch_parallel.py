"""Port parity: env-axis sharding over torch.distributed (parallel/mesh.py).

Each multi-rank case runs this file as a worker in spawned gloo processes
on the CPU (a free port each, one thread each, a finite process-group
timeout, and a bounded wait, so a hang fails the test). Every rank builds
the same full-width env and keeps its shard:

- 2 ranks x FrankaOscEnv(num_envs=16) on the Panda stand-in: shard_step on
  the physics step, the full control step with its shard's `refs`,
  rollout_with_obs for 3 steps (obs: dof_pos and the hand's body_pos), and
  psum_metrics; BallsEnv(num_worlds=4) through the sphere-world solve's
  plain version, with the contact force summed over ranks.
- 4 ranks on make_2d_mesh(dcn=2, ici=2): the gathered obs in global env
  order.

The ranks' results must equal one port process stepping all the envs to
1e-6 * max(|ref|, 1) (they come out bitwise on the CPU; the balls to 1e-5
of the largest magnitude), and the Franka ones the JAX package to the
goldens' 1e-4 * max(|ref|, 1): JAX parallel.mesh.rollout_with_obs on a
2-device slice of the virtual CPU mesh tests/conftest.py forces, and the
single-device jitted JAX step.
"""
import datetime
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from test_isaacgym_tpu_torch.envs.balls import BallsEnv
from test_isaacgym_tpu_torch.envs.franka import STANDIN_ROOT, FrankaOscEnv
from test_isaacgym_tpu_torch.parallel import mesh as pm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ENVS, STEPS = 16, 3
BALL_WORLDS, BALL_PYRAMIDS, BALL_STEPS = 4, 4, 30
TOL, JAX_TOL, BALL_TOL = 1e-6, 1e-4, 1e-5
PG_TIMEOUT = 120  # seconds a collective may wait for a peer
WAIT = 300  # seconds a case's processes may take in all
STATE_KEYS = ("dof_pos", "dof_vel", "body_pos", "root_pos")


def close(got, want, what, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol} * {scale:.3g}"


def franka_obs(env):
    return lambda s: torch.cat([s.dof_pos, s.body_pos[:, env.hand_body]], dim=-1)


def _save_state(res, prefix, s):
    for k in STATE_KEYS:
        res[f"{prefix}.{k}"] = getattr(s, k).numpy()


# ---------------------------------------------------------------- the ranks
def _case_env(res, mesh):
    """2 ranks on the 'env' mesh: Franka OSC and the balls."""
    env = FrankaOscEnv(num_envs=N_ENVS, device="cpu")
    sim = env.sim
    st, ac, pa = (pm.shard_env_tree(t, mesh, N_ENVS) for t in (sim.state, sim.actions, sim.params))
    res["shard_index"] = np.array(pm._shard_index(mesh, "env"))
    try:
        pm.shard_env_tree({"x": torch.zeros(5, 2)}, mesh, 5)
    except ValueError:
        res["refused_indivisible"] = np.array(True)
    try:
        pm.shard_step(sim.stepper.step, mesh, st, ac, sim.params)
    except ValueError:
        res["refused_global_leaf"] = np.array(True)

    step = pm.shard_step(sim.stepper.step, mesh, st, ac, pa)
    _save_state(res, "physics", step(st, ac, pa))
    refs = pm.shard_env_tree((env.init_hand_pos, env.init_hand_quat, env.origins), mesh, N_ENVS)
    full = pm.shard_step(lambda s, a, p: env._step_impl(s, a, p, s.steps, refs), mesh, st, ac, pa)
    _save_state(res, "full", full(st, ac, pa))
    run = pm.rollout_with_obs(sim.stepper.step, franka_obs(env), mesh, st, ac, pa, STEPS)
    final, obs = run(st, ac, pa)
    res["obs"] = obs.numpy()
    _save_state(res, "rollout", final)
    metrics = {"dof_vel": final.dof_vel.sum(0), "body_pos": final.body_pos.sum((0, 1)),
               "envs": torch.tensor(float(final.dof_pos.shape[0]))}
    for k, v in pm.psum_metrics(metrics, mesh).items():
        res[f"psum.{k}"] = v.numpy()

    benv = BallsEnv(num_worlds=BALL_WORLDS, pyramids=BALL_PYRAMIDS, device="cpu")
    bs, ba, bp = (pm.shard_env_tree(t, mesh, BALL_WORLDS)
                  for t in (benv.sim.state, benv.sim.actions, benv.sim.params))
    out = pm.shard_step(lambda s, a, p: benv.sim.stepper.rollout(s, a, p, BALL_STEPS),
                        mesh, bs, ba, bp)(bs, ba, bp)
    res["balls.root_pos"] = out.root_pos.numpy()
    res["balls.force"] = pm.psum_metrics(out.contact_force.sum((0, 1)), mesh).numpy()


def _case_2d(res, mesh):
    """4 ranks on the ('dcn', 'ici') mesh: the rollout's gathered obs."""
    ax = ("dcn", "ici")
    env = FrankaOscEnv(num_envs=N_ENVS, device="cpu")
    sim = env.sim
    st, ac, pa = (pm.shard_env_tree(t, mesh, N_ENVS, ax) for t in (sim.state, sim.actions, sim.params))
    res["shard_index"] = np.array(pm._shard_index(mesh, ax))
    res["mesh_coord"] = np.array([mesh.get_local_rank("dcn"), mesh.get_local_rank("ici")])
    run = pm.rollout_with_obs(sim.stepper.step, franka_obs(env), mesh, st, ac, pa, STEPS, ax)
    final, obs = run(st, ac, pa)
    res["obs"] = obs.numpy()
    _save_state(res, "rollout", final)
    res["psum.envs"] = pm.psum_metrics(torch.tensor(float(final.dof_pos.shape[0])), mesh,
                                       ax).numpy()


def worker(case, rank, world, port, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    pm.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                        timeout=datetime.timedelta(seconds=PG_TIMEOUT))
    try:
        res = {"backend": np.array(dist.get_backend())}
        if case == "env":
            _case_env(res, pm.make_env_mesh())
        else:
            _case_2d(res, pm.make_2d_mesh(dcn=2, ici=2))
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(case, world):
    """Each rank's saved results, from `world` spawned worker processes."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.dirname(__file__)]),
               OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    with tempfile.TemporaryDirectory(prefix="torch_parallel_") as td:
        outs = [os.path.join(td, f"rank{r}.npz") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), case, str(r), str(world),
             str(port), outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT,
        ) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=WAIT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
        results = []
        for o in outs:
            with np.load(o) as z:
                results.append(dict(z))
        return results


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def two_ranks():
    return run_ranks("env", 2)


@pytest.fixture(scope="module")
def four_ranks():
    return run_ranks("2d", 4)


def _state(s):
    return {k: getattr(s, k).numpy() for k in STATE_KEYS}


@pytest.fixture(scope="module")
def one_process():
    """One port process stepping all the envs."""
    env = FrankaOscEnv(num_envs=N_ENVS, device="cpu")
    sim = env.sim
    s0, a, p = sim.state, sim.actions, sim.params
    ref = {"physics": _state(sim.stepper.step(s0, a, p)),
           "full": _state(env._step_impl(s0, a, p, s0.steps))}
    s, obs = s0, []
    for _ in range(STEPS):
        s = sim.stepper.step(s, a, p)
        obs.append(franka_obs(env)(s))
    ref["rollout"], ref["obs"] = _state(s), torch.stack(obs).numpy()
    ref["psum"] = {"dof_vel": s.dof_vel.sum(0).numpy(), "body_pos": s.body_pos.sum((0, 1)).numpy()}
    benv = BallsEnv(num_worlds=BALL_WORLDS, pyramids=BALL_PYRAMIDS, device="cpu")
    bs = benv.rollout_fn(BALL_STEPS)(benv.sim.state)
    ref["balls.root_pos"] = bs.root_pos.numpy()
    ref["balls.force"] = bs.contact_force.sum((0, 1)).numpy()
    return ref


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package on the same stand-in: rollout_with_obs on 2 devices of
    the virtual CPU mesh (physics step), and the jitted single-device full
    control step."""
    import jax
    import jax.numpy as jnp

    from test_isaacgym_tpu.envs.franka import FrankaOscEnv as JaxFranka
    from test_isaacgym_tpu.parallel import mesh as jm

    env = JaxFranka(num_envs=N_ENVS, asset_root=STANDIN_ROOT)
    sim = env.sim
    mesh = jm.make_env_mesh(jax.devices()[:2])
    st, ac, pa = (jm.shard_env_tree(t, mesh, N_ENVS) for t in (sim.state, sim.actions, sim.params))
    hand = env.hand_body
    run = jm.rollout_with_obs(
        sim.stepper.step, lambda s: jnp.concatenate([s.dof_pos, s.body_pos[:, hand]], -1),
        mesh, st, ac, pa, STEPS,
    )
    final, obs = run(st, ac, pa)
    full = jax.jit(env._step_impl)(sim.state, sim.actions, sim.params, sim.state.steps)
    return {"obs": np.asarray(obs), "rollout": {k: np.asarray(getattr(final, k)) for k in STATE_KEYS},
            "full": {k: np.asarray(getattr(full, k)) for k in STATE_KEYS}}


def _global(ranks, key):
    """The ranks' local shards of `key`, in shard order, as one array."""
    order = sorted(range(len(ranks)), key=lambda r: int(ranks[r]["shard_index"][0]))
    return np.concatenate([ranks[r][key] for r in order])


# ---------------------------------------------------------------- the tests
def test_init_distributed_without_coordinator_is_a_noop(monkeypatch):
    import torch.distributed as dist

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pm.init_distributed(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        pm.init_distributed(num_processes=2, device="cpu")  # no coordinator
    with pytest.raises(RuntimeError):
        pm.make_env_mesh()  # no process group to make a mesh of


def test_env_specs_shard_the_env_leading_leaves():
    from torch.distributed.tensor import Replicate, Shard

    env = FrankaOscEnv(num_envs=4, device="cpu")
    specs = pm.env_specs(env.sim.state, 4)
    assert type(specs) is type(env.sim.state)
    assert specs.dof_pos == Shard(0) and specs.body_pos == Shard(0)
    assert specs.steps == Replicate() and specs.time == Replicate()
    assert specs.warm_n is None and env.sim.state.warm_n is None
    assert pm.env_specs(env.sim.params, 4).gravity == Replicate()


def test_shard_env_tree_places_each_rank_slice(two_ranks, four_ranks):
    assert [int(r["shard_index"][0]) for r in two_ranks] == [0, 1]
    assert all(str(r["backend"]) == "gloo" for r in two_ranks)
    # (dcn, ici) coordinates in rank order, linear index dcn * ici + ici_idx
    assert [tuple(r["mesh_coord"]) for r in four_ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [int(r["shard_index"][0]) for r in four_ranks] == [0, 1, 2, 3]
    assert all(r["rollout.dof_pos"].shape[0] == N_ENVS // 4 for r in four_ranks)


def test_shard_env_tree_refuses_indivisible_and_global_leaves(two_ranks):
    """N % R != 0 raises; so does a step handed a tree left at full width."""
    for r in two_ranks:
        assert r.get("refused_indivisible", False)
        assert r.get("refused_global_leaf", False)


def test_sharded_physics_step_matches_one_process(two_ranks, one_process):
    for k in STATE_KEYS:
        close(_global(two_ranks, f"physics.{k}"), one_process["physics"][k], f"physics {k}", TOL)


def test_sharded_full_control_step_with_refs(two_ranks, one_process, jax_run):
    """The OSC control + physics step on a shard reads its shard's refs
    (init_hand_pos, init_hand_quat, origins): it equals one process's full
    step and the JAX package's."""
    for k in STATE_KEYS:
        got = _global(two_ranks, f"full.{k}")
        close(got, one_process["full"][k], f"full step {k}", TOL)
        close(got, jax_run["full"][k], f"full step {k} vs jax", JAX_TOL)


def test_rollout_with_obs_matches_one_process_and_jax(two_ranks, one_process, jax_run):
    for r in two_ranks:
        assert r["obs"].shape == (STEPS, N_ENVS, 12)
        close(r["obs"], one_process["obs"], "gathered obs", TOL)
        close(r["obs"], jax_run["obs"], "gathered obs vs jax", JAX_TOL)
    np.testing.assert_array_equal(two_ranks[0]["obs"], two_ranks[1]["obs"])
    for k in STATE_KEYS:
        got = _global(two_ranks, f"rollout.{k}")
        close(got, one_process["rollout"][k], f"final {k}", TOL)
        close(got, jax_run["rollout"][k], f"final {k} vs jax", JAX_TOL)


def test_psum_metrics_equals_the_sum_on_one_process(two_ranks, one_process):
    for r in two_ranks:
        assert float(r["psum.envs"]) == N_ENVS
        for k in ("dof_vel", "body_pos"):
            close(r[f"psum.{k}"], one_process["psum"][k], f"psum {k}", TOL)


def test_sharded_balls_match_unsharded(two_ranks, one_process):
    """4 worlds of 120 balls over 2 ranks, through the solve's plain version;
    the ground contact force summed over ranks."""
    close(_global(two_ranks, "balls.root_pos"), one_process["balls.root_pos"], "ball positions",
          BALL_TOL)
    for r in two_ranks:
        close(r["balls.force"], one_process["balls.force"], "summed contact force", BALL_TOL)


def test_2d_mesh_gathers_in_global_env_order(four_ranks, one_process):
    for r in four_ranks:
        close(r["obs"], one_process["obs"], "obs gathered over ('dcn', 'ici')", TOL)
        assert float(r["psum.envs"]) == N_ENVS
    for k in STATE_KEYS:
        close(_global(four_ranks, f"rollout.{k}"), one_process["rollout"][k], f"final {k}", TOL)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

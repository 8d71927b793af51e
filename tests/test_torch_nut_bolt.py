"""Port parity: SDF contact stepped, and NutBoltEnv, against the JAX package.

  * tests/test_nut_bolt.py::test_sdf_probe_contact_depth's scene (a
    tetrahedron dropped on a box whose SDF is a numpy-only closed form, so
    a voxel grid): 60 steps of the port against the JAX Simulator every 10
    steps at the goldens' rule, 1e-4 * max(|ref|, 1), and that test's own
    bounds on the port;
  * NutBoltEnv (the code-built nut stand-in on the procedural bolt, the
    nut's probes against the bolt's closed form): the port's build gives
    the JAX env's table, state and params; 2 envs, 30 steps, the root pose
    and velocity every 10 at the goldens' rule (the contact force is not
    held: see NUT_FIELDS);
  * the port's analytic-vs-voxel parity at the bar of
    test_analytic_vs_voxel_narrowphase_parity (the closed form stripped with
    TIG_NO_ANALYTIC_SDF=1, so both directions run on voxel grids; 30 steps,
    within 1e-3 m);
  * a step under TIG_DEBUG=1 (the contact-table asserts on SDF rows) pure
    and repeatable;
  * co-located envs (env_spacing 0) bitwise equal after 60 steps;
  * the port against the committed golden nut_bolt_standin.npz (made by the
    JAX package on the stand-in);
  * the committed stand-in is tools/make_nut_standin.py's output, a closed
    mesh 0.035 m across flats and 0.016 m high.

Both packages' SDF caches point at a temporary directory for this module,
so no process reads a grid another is writing.

Run as a script, this regenerates the golden (2 envs, the nut's root pose
every 5 steps up to the JAX package's own jitted-vs-op-by-op agreement)
and the full-width numbers chip_smoke.py bounds the card by: the JAX env's
descent of every one of 1024 envs after 240 steps (bench.py's nut_bolt
config), with the bar of test_nut_threads_down:
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_nut_bolt.py
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_isaacgym_tpu.assets.sdf as jsdf  # noqa: E402
import test_isaacgym_tpu.envs.nut_bolt as jnb  # noqa: E402
import test_isaacgym_tpu_torch.assets.sdf as tsdf  # noqa: E402
from test_isaacgym_tpu_torch.core.state import to_numpy  # noqa: E402
from test_isaacgym_tpu_torch.envs import nut_bolt as tnb  # noqa: E402
from test_torch_contacts import rolled_scan  # noqa: E402
from test_torch_kinematics import JAX, PORT, close  # noqa: E402
from test_torch_sdf import box_mesh, box_sdf, tetra_mesh  # noqa: E402

torch.set_num_threads(1)

STEP_TOL = 1e-4
FIELDS = ("root_pos", "root_quat", "root_linvel", "root_angvel", "contact_force")
# NutBoltEnv's contact force is not held: the nut's 16 thread rows press
# near-parallel flanks, and how the relaxed-Jacobi solve splits the load
# between them rests on the last bits; the JAX package's own jitted and
# op-by-op steps part by 1.4e-4 of the largest force after 4 steps (CPU)
NUT_FIELDS = FIELDS[:4]
GOLDEN = os.path.join(tnb.NUT_STANDIN_ROOT, "..", "nut_bolt_standin.npz")
GOLDEN_ENVS, GOLDEN_EVERY, GOLDEN_STEPS = 2, 5, 60
BIG_ENVS, BIG_STEPS = 1024, 240  # bench.py's nut_bolt@1024; 2 s at 1 rev/s


@pytest.fixture(scope="module", autouse=True)
def grid_caches(tmp_path_factory):
    d = tmp_path_factory.mktemp("sdf_cache")
    saved = jsdf._CACHE_DIR, tsdf._CACHE_DIR
    jsdf._CACHE_DIR, tsdf._CACHE_DIR = str(d / "jax"), str(d / "torch")
    yield
    jsdf._CACHE_DIR, tsdf._CACHE_DIR = saved


def jax_env(**kw):
    return jnb.NutBoltEnv(asset_root=tnb.NUT_STANDIN_ROOT, **kw)


def port_env(**kw):
    return tnb.NutBoltEnv(device="cpu", **kw)


def _state_close(s, js, what, fields=FIELDS):
    got = to_numpy(s)
    for f in fields:
        close(got[f], np.asarray(getattr(js, f)), f"{what} {f}", tol=STEP_TOL)


def probe_scene(pkg):
    """tests/test_nut_bolt.py::test_sdf_probe_contact_depth's scene: a
    0.2 m box carrying its numpy SDF (fixed) and a tetrahedron above it."""
    import importlib

    prim, sdf, cfg, sc, sm = (importlib.import_module(f"{pkg}.{m}") for m in (
        "assets.primitives", "assets.sdf", "core.config", "core.scene", "core.sim"))
    grid = sdf.sdf_from_fn(box_sdf, (-0.1, -0.1, -0.1), (0.1, 0.1, 0.1))
    carrier = prim.create_mesh_asset("sdfbox", *box_mesh(), density=1000.0, sdf=grid,
                                     fix_base_link=True)
    probe = prim.create_mesh_asset("tetra", *tetra_mesh(), density=500.0)
    b = sc.SceneBuilder(cfg.SimParams(dt=1 / 120, substeps=2, gravity=(0.0, 0.0, -9.8)))
    b.create_env((-1, -1, 0), (1, 1, 1), 1)
    b.create_actor(0, carrier, pos=(0, 0, 0.5), name="box", group=0, filter=0)
    b.create_actor(0, probe, pos=(0, 0, 0.64), name="tetra", group=0, filter=0)
    if pkg == JAX:
        return sm.Simulator(*b.finalize())
    return sm.Simulator(*b.finalize("cpu"), device="cpu")


def test_sdf_probe_contact_depth_like_jax():
    jsim, sim = probe_scene(JAX), probe_scene(PORT)
    c = sim.stepper.contact
    assert set(c.job.kind.tolist()) == {17} and c.sdf_analytic_groups == []
    js, s = jsim.state, sim.state
    with rolled_scan():
        run = jax.jit(lambda st: jsim.stepper.rollout(st, jsim.actions, jsim.params, 10))
        for k in range(1, 7):
            js = run(js)
            s = sim.stepper.rollout(s, sim.actions, sim.params, 10)
            _state_close(s, js, f"tetra on box after {10 * k} steps")
    slot = sim.scene.find_actor("tetra").slot
    # the JAX test's bounds: it rests with its lowest vertex on the box top
    assert abs(float(s.root_pos[0, slot, 2]) - 0.62) < 5e-3
    assert float(s.root_linvel[0, slot].abs().max()) < 0.05


@pytest.fixture(scope="module")
def envs():
    return jax_env(num_envs=2), port_env(num_envs=2)


def test_scene_build_matches_jax(envs):
    jenv, env = envs
    jc, c = jenv.sim.stepper.contact, env.sim.stepper.contact
    assert c.num_contacts == jc.num_contacts == 20  # 16 SDF rows + 4 nut-ground
    for f in ("kind", "shape_a", "shape_b", "slot"):
        np.testing.assert_array_equal(getattr(c.job, f), getattr(jc.job, f), f)
    assert c.sdf_data is None and len(c.sdf_analytic_groups) == 1  # the bolt's closed form
    np.testing.assert_array_equal(c.sdf_probes, np.asarray(jc.sdf_probes))
    assert env.nut_slot == jenv.nut_slot and env.pitch == jenv.pitch
    for k, want in jenv.sim.initial_state._asdict().items():
        if want is not None and np.size(want):
            close(getattr(env.sim.initial_state, k).numpy(), np.asarray(want), f"state.{k}")
    for k, want in jenv.sim.params._asdict().items():
        if want is not None and np.size(want):
            np.testing.assert_array_equal(getattr(env.sim.params, k).numpy(), np.asarray(want), k)


def test_nut_bolt_steps_like_jax(envs):
    jenv, env = envs
    js, s = jenv.sim.state, env.sim.state
    with rolled_scan():
        run = jax.jit(jenv.rollout_fn(10))
        for k in range(1, 4):
            js = run(js)
            s = env.rollout(10, s)
            _state_close(s, js, f"nut_bolt after {10 * k} steps", NUT_FIELDS)
    # the stand-in mates in both packages, and the spun nut goes down
    assert float((env.nut_height(s) - env.nut_height(env.sim.state)).max()) < -1e-4
    assert float((jenv.nut_height(js) - jenv.nut_height(jenv.sim.state)).max()) < -1e-4


def test_nut_standin_is_the_generators(tmp_path):
    """The committed nut stand-in is what tools/make_nut_standin.py writes,
    byte for byte, and its mesh is closed with outward faces."""
    from collections import Counter

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools)
    try:
        import make_nut_standin as mk
    finally:
        sys.path.remove(tools)
    mk.write(str(tmp_path))
    for name in (mk.URDF, os.path.join(os.path.dirname(mk.URDF), mk.OBJ)):
        with open(tmp_path / name, "rb") as a, open(os.path.join(tnb.NUT_STANDIN_ROOT, name), "rb") as b:
            assert a.read() == b.read(), name
    verts, faces = mk.nut_mesh()
    edges = Counter((int(a), int(b)) for f in faces for a, b in zip(f, np.roll(f, -1)))
    assert all(n == 1 and edges[(b, a)] == 1 for (a, b), n in edges.items())
    tri = verts[faces]
    volume = np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() / 6
    assert volume > 0
    flats = mk.ACROSS_FLATS
    assert np.isclose(verts[:, 0].max() - verts[:, 0].min(), flats)
    assert np.isclose(np.ptp(verts[:, 2]), mk.HEIGHT)


def test_analytic_vs_voxel_parity(monkeypatch):
    """The closed-form path and the voxel path (TIG_NO_ANALYTIC_SDF=1: both
    grids voxel, both directions) give the same thread contact within the
    JAX test's 1e-3 m after 30 steps."""
    ana = port_env(num_envs=2)
    monkeypatch.setenv("TIG_NO_ANALYTIC_SDF", "1")
    vox = port_env(num_envs=2)
    cv = vox.sim.stepper.contact
    assert cv.sdf_analytic_groups == [] and len(cv.sdf_voxel_q) == 2
    a = ana.rollout(30).root_pos[:, ana.nut_slot].numpy()
    v = vox.rollout(30).root_pos[:, vox.nut_slot].numpy()
    np.testing.assert_allclose(a, v, atol=1e-3)


def test_sdf_step_under_debug(monkeypatch):
    """TIG_DEBUG=1: the contact-table asserts run on SDF rows, and the step
    is pure and repeatable."""
    from test_isaacgym_tpu_torch.utils import debug

    monkeypatch.setenv("TIG_DEBUG", "1")
    env = port_env(num_envs=2)
    stp = env.sim.stepper
    assert stp.debug and 17 in stp.contact.job.kind
    st = debug.verify_step_purity(stp, env._spun(env.sim.state), env.sim.actions, env.sim.params)
    assert torch.isfinite(st.root_pos).all()


def test_colocated_envs_bitwise():
    env = port_env(num_envs=2, env_spacing=0.0)
    s = env.rollout(60)
    np.testing.assert_array_equal(s.root_pos[0].numpy(), s.root_pos[1].numpy())


def test_golden_reproduced_by_port():
    golden = np.load(GOLDEN)
    env = port_env(num_envs=int(golden["num_envs"]))
    s = env.sim.state
    for i in range(len(golden["nut_pos"])):
        if i:
            s = env.rollout(GOLDEN_EVERY, s)
        close(s.root_pos[:, env.nut_slot].numpy(), golden["nut_pos"][i], f"nut_pos {i}",
              tol=STEP_TOL)
        close(s.root_quat[:, env.nut_slot].numpy(), golden["nut_quat"][i], f"nut_quat {i}",
              tol=STEP_TOL)
    assert int(golden["self_agree"]) >= GOLDEN_EVERY * (len(golden["nut_pos"]) - 1)


def test_default_device_is_cuda():
    import dataclasses

    fields = {f.name: f.default for f in dataclasses.fields(tnb.NutBoltEnv)}
    assert fields["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tnb.NutBoltEnv(num_envs=1)


# ---------------------------------------------------------------------------
# the golden, run as a script

def main():
    from test_torch_hull import rel_err

    with rolled_scan():
        env = jax_env(num_envs=GOLDEN_ENVS)
        step = jax.jit(env.rollout_fn(1))
        a = b = env.sim.state
        agree, snaps = GOLDEN_STEPS, []
        for k in range(GOLDEN_STEPS + 1):
            if k % GOLDEN_EVERY == 0:
                snaps.append((np.asarray(a.root_pos[:, env.nut_slot]),
                              np.asarray(a.root_quat[:, env.nut_slot])))
            if k == GOLDEN_STEPS:
                break
            a = step(a)
            with jax.disable_jit():
                b = env.rollout_fn(1)(b)
            err = rel_err(b, a)
            print(f"  step {k + 1}: jitted vs op by op {err:.3e}", flush=True)
            if err > STEP_TOL:
                agree = k
                break
        keep = agree // GOLDEN_EVERY + 1
        print(f"nut_bolt {GOLDEN_ENVS} envs: jitted and op-by-op JAX agree for {agree} steps",
              flush=True)
        big = jax_env(num_envs=BIG_ENVS)
        s = jax.jit(big.rollout_fn(BIG_STEPS))(big.sim.state)
        dz = np.asarray(big.nut_height(s)) - np.asarray(big.nut_height(big.sim.state))
    expected = 2 * big.pitch * big.spin / (2 * np.pi)
    ok = bool(np.all(np.abs(dz - expected) <= 0.2 * abs(expected)) and np.ptp(dz) < 5e-4)
    print(f"nut_bolt JAX {BIG_ENVS} envs after {BIG_STEPS} steps: descent {dz.min():.6f} to "
          f"{dz.max():.6f} m (mean {dz.mean():.6f}), expected {expected:.6f}; the bar of "
          f"test_nut_threads_down {'met' if ok else 'NOT met'}")
    np.savez_compressed(
        os.path.abspath(GOLDEN), num_envs=GOLDEN_ENVS, self_agree=agree,
        nut_pos=np.stack([p for p, _ in snaps[:keep]]),
        nut_quat=np.stack([q for _, q in snaps[:keep]]),
        jax_descent_min=dz.min(), jax_descent_max=dz.max(), jax_descent_mean=dz.mean(),
        jax_bar_met=ok, big_envs=BIG_ENVS, big_steps=BIG_STEPS, every=GOLDEN_EVERY)
    print(f"wrote {os.path.abspath(GOLDEN)}")


if __name__ == "__main__":
    main()


def test_rollout_fn_is_the_jax_method(envs):
    """NutBoltEnv.rollout_fn(num_steps) -> (state -> state) has the JAX
    env's name, signature and steps; rollout stays as its alias."""
    import inspect

    assert (list(inspect.signature(tnb.NutBoltEnv.rollout_fn).parameters)
            == list(inspect.signature(jnb.NutBoltEnv.rollout_fn).parameters))
    jenv, env = envs
    with rolled_scan():
        js = jax.jit(jenv.rollout_fn(10))(jenv.sim.state)
    s = env.rollout_fn(10)(env.sim.state)
    _state_close(s, js, "nut_bolt rollout_fn(10)", NUT_FIELDS)
    assert torch.equal(env.rollout(10).root_pos, s.root_pos)

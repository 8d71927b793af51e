"""Port parity: FEM soft bodies (physics/soft.py) against the JAX package.

  * the host half on the code-built icosphere stand-in: `load_tet` on a
    file written to tmp_path, `surface_triangles`, `_fix_winding`,
    `lame_params`, and `build_soft_world` field by field (1e-6) on the
    soft_body scene (envs/soft_body.py: the reference's
    examples/soft_body.py) and on the pedestal scene
    (tests/test_soft.py::test_soft_settles_on_sphere_capsule_hull), with
    the initial soft state and materials;
  * `substep` on random deformed states, with the ground, a box, a sphere,
    a capsule and a convex hull each alone (one vertex exactly on an
    argmax tie of the box), against the JAX function run op by op, to 1e-5
    of the largest magnitude. Op by op because the jitted JAX step
    contracts the cross products' a*b - c*d into fused multiply-adds, and
    the stiff hydrostatic constraint amplifies those last bits: its own
    jitted and op-by-op substeps part by ~8e-5 m at the FleX budget, the
    port and its op-by-op run by ~3e-7;
  * `tet_stress` and `tri_normals` (1e-5), and det(F) as the triple product
    of F's columns within 1e-6 of `jnp.linalg.det`;
  * reset restoring soft_pos whole and per env, a step under TIG_DEBUG=1,
    `from_numpy` carrying a JAX soft state, both goldens, and the stand-in
    generator byte for byte.
The stepped runs against the JAX package are tests/test_torch_soft_steps.py.

Run as a script, this regenerates the two goldens that chip_smoke.py holds
the card to (test_isaacgym_tpu_torch/assets/data/soft_body_standin.npz and
soft_pedestals_standin.npz: the JAX package's op-by-op soft_pos every step
up to its own jitted-vs-op-by-op agreement; the port tracks that run within
~1e-6 on the CPU and on the H100, the jitted one at the horizon's edge),
the horizons of the stepped tests, the
JAX package's per-env lowest vertex and volume ratio of the soft_body scene
at 1024 envs after 120 steps (soft_body1024 on the card; run in 64-env
chunks of the 1024-env build, every env independent), and the same two
numbers of the 4-env golden scene after 120 steps jitted and op by op,
whose difference sets the card's slack (~1 h on 8 cores, three worker
processes):
    PYTHONPATH=. JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_use_fusion_emitters=false \\
        python tests/test_torch_soft.py
and then, with --big-opbyop, the same 1024 envs op by op added to the
golden beside the jitted numbers (~1.5 h, two processes): the arithmetic
the port follows, which chip_smoke.py's soft_body1024 is held to.
"""
import dataclasses
import multiprocessing
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_isaacgym_tpu.assets.primitives as jprim  # noqa: E402
import test_isaacgym_tpu.core.config as jcfg  # noqa: E402
import test_isaacgym_tpu.physics.soft as jsoft  # noqa: E402
from test_isaacgym_tpu.assets import load_urdf as jax_load_urdf  # noqa: E402
from test_isaacgym_tpu.core.scene import SceneBuilder as JaxBuilder  # noqa: E402
from test_isaacgym_tpu.core.sim import Simulator as JaxSimulator  # noqa: E402
from test_isaacgym_tpu_torch.assets import load_urdf  # noqa: E402
from test_isaacgym_tpu_torch.core.state import SimState, from_numpy, to_numpy  # noqa: E402
from test_isaacgym_tpu_torch.envs import soft_body as sb  # noqa: E402
from test_isaacgym_tpu_torch.physics import soft  # noqa: E402
from test_torch_contacts import rolled_scan  # noqa: E402
from test_torch_kinematics import close  # noqa: E402
from test_torch_soft_kernel import (SUBSTEP_ITERS, alone, deformed_state,  # noqa: E402
                                    substep_inputs)

torch.set_num_threads(1)

HOST_TOL, FN_TOL, STEP_TOL = 1e-6, 1e-5, 1e-4
DATA = os.path.dirname(sb.STANDIN_ROOT)
GOLDEN = os.path.join(DATA, "soft_body_standin.npz")
PEDESTALS_GOLDEN = os.path.join(DATA, "soft_pedestals_standin.npz")
GOLDEN_ENVS = 4
# the stepped tests: tests/test_soft.py's _make_sim drop (height 1.2, the
# rail's speed limit 0.5) of two envs of Young's 3e4 and 6e5, and its press
# (1 env, height 1.05) with the rail commanded to -1 from the start: after
# PRESS_DOWN steps the plate is pressing the ball (the ground pushes the
# ball, which starts 0.45 m into it, up against the plate at once)
DROP_YOUNGS = (3e4, 6e5)
PRESS_HEIGHT, PRESS_DOWN = 1.05, 10
# soft_body1024 on the card, and the 4-env agreement run
BIG_ENVS, BIG_STEPS, CHUNK = 1024, 120, 64
# the same envs op by op: an op costs about the same at 64 and 1024 envs on
# the CPU (18.5 s and 56 s a step), so that run takes 512 envs a process
OPBYOP_CHUNK = 512
RIGID_FIELDS = ("root_pos", "root_quat", "dof_pos", "dof_vel")


# ---------------------------------------------------------------------------
# the scenes in both packages

def jax_drop(num_envs, height=sb.DROP_HEIGHT, **fields):
    """The JAX Simulator of the soft_body scene (drop_fields' keywords)."""
    b = sb.build_drop(JaxBuilder(sb.soft_params(jcfg)), jcfg,
                      sb.icosphere(jax_load_urdf, sb.SOFT_THICKNESS), num_envs, height)
    jsim = JaxSimulator(*b.finalize())
    f = sb.drop_fields(jsim.scene, **fields)
    jsim.params = jsim.params._replace(**{k: jnp.asarray(v) for k, v in f.items()})
    return jsim


def jax_pedestals():
    b = sb.build_pedestals(JaxBuilder(sb.soft_params(jcfg, up_y=False)), jcfg, jprim,
                           sb.icosphere(jax_load_urdf, sb.PEDESTAL_THICKNESS))
    return JaxSimulator(*b.finalize())


def drop_kwargs():
    return dict(height=1.2, materials=False, youngs=DROP_YOUNGS, max_velocity=0.5)


def press_kwargs():
    return dict(height=PRESS_HEIGHT, materials=False, max_velocity=0.5)


def press_start(jsim):
    """(the rail commanded to -1, the JAX state PRESS_DOWN steps into the
    press) of the press scene jsim."""
    down = jsim.actions._replace(dof_pos_target=jsim.actions.dof_pos_target.at[:].set(-1.0))
    step = jax.jit(jsim.stepper.step)
    st = jsim.state
    for _ in range(PRESS_DOWN):
        st = step(st, down, jsim.params)
    return down, st


def soft_rel_err(a, b):
    """max |a - b| / max(|b|, 1) of soft_pos."""
    a, b = np.asarray(a.soft_pos), np.asarray(b.soft_pos)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def volume_ratio(world, pos):
    """Each env's total tet volume over the rest volume (tests/test_soft.py)."""
    x = pos[:, world.tets]
    d0, d1, d2 = (x[:, :, k] - x[:, :, 0] for k in (1, 2, 3))
    vol = np.abs(np.einsum("ntj,ntj->nt", np.cross(d0, d1), d2)) / 6.0
    return vol.sum(-1) / world.rest_vol.sum()


def _port_state(jstate, device="cpu"):
    return from_numpy({k: None if v is None else np.asarray(v)
                       for k, v in jstate._asdict().items()}, SimState, device)


# ---------------------------------------------------------------------------
# the host half

def _cube_tets():
    """A unit cube split into 5 tets."""
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
    t = np.array([[0, 1, 2, 4], [3, 1, 2, 7], [5, 1, 4, 7], [6, 2, 4, 7], [1, 2, 4, 7]], np.int32)
    return v, t


def test_load_tet_and_topology_like_jax(tmp_path):
    v, t = _cube_tets()
    path = tmp_path / "cube.tet"
    path.write_text("# a cube\n" + "".join(f"v {a} {b} {c}\n" for a, b, c in v)
                    + "\n" + "".join(f"t {a} {b} {c} {d}\n" for a, b, c, d in t))
    for (got, want) in zip(soft.load_tet(str(path)), jsoft.load_tet(str(path))):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(soft.load_tet(str(path))[1], t)
    (tmp_path / "bad.tet").write_text("v 0 0 0\nt 0 1 2 3\n")
    with pytest.raises(ValueError, match="malformed"):
        soft.load_tet(str(tmp_path / "bad.tet"))
    sv, st = soft.load_tet(os.path.join(sb.STANDIN_ROOT, "urdf", "icosphere.tet"))
    for tets, verts in ((t, v), (st, sv)):
        got, want = soft.surface_triangles(tets), jsoft.surface_triangles(tets)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(soft._fix_winding(verts, got[0], got[2]),
                                      jsoft._fix_winding(verts, *want[::2]))
    rng = np.random.RandomState(3)
    E, nu = rng.uniform(1e4, 1e6, 16).astype(np.float32), rng.uniform(0.1, 0.49, 16).astype(np.float32)
    want = jsoft.lame_params(jnp.asarray(E), jnp.asarray(nu))
    for got in (soft.lame_params(E, nu), soft.lame_params(torch.as_tensor(E), torch.as_tensor(nu))):
        for a, b in zip(got, want):
            close(np.asarray(a), np.asarray(b), "lame", tol=HOST_TOL)


def _same_world(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "instances":
            assert [vars(i) for i in a] == [vars(i) for i in b]
        elif isinstance(b, np.ndarray) and b.dtype.kind == "f":
            assert a.dtype == b.dtype, f.name
            close(a, b, f.name, tol=HOST_TOL)
        else:
            np.testing.assert_array_equal(a, b, f.name)


@pytest.mark.parametrize("scene", ["soft_body", "pedestals"])
def test_soft_world_matches_jax(scene):
    if scene == "soft_body":
        jsim, sim = jax_drop(2), sb.soft_body_sim(2, device="cpu")
    else:
        jsim, sim = jax_pedestals(), sb.pedestals_sim(device="cpu")
    _same_world(sim.scene.soft, jsim.scene.soft)
    w = sim.scene.soft
    assert len(w.tris) == 320 * len(w.instances)
    assert sorted(set(w.col_kind.tolist())) == ([1] if scene == "soft_body" else [0, 1, 2, 3])
    for name in ("soft_pos", "soft_vel"):
        close(getattr(sim.state, name).numpy(), np.asarray(getattr(jsim.state, name)), name,
              tol=HOST_TOL)
    for name in ("soft_youngs", "soft_poissons", "soft_damping", "dof_stiffness",
                 "dof_max_effort", "gravity"):
        np.testing.assert_array_equal(getattr(sim.params, name).numpy(),
                                      np.asarray(getattr(jsim.params, name)), name)
    # the scene's grid, ground and gravity with UP_AXIS_Y are the JAX scene's
    np.testing.assert_array_equal(sim.scene.env_origins, jsim.scene.env_origins)
    assert vars(sim.scene.ground) == vars(jsim.scene.ground)


# ---------------------------------------------------------------------------
# single functions

@pytest.fixture(scope="module")
def pedestals():
    return jax_pedestals(), sb.pedestals_sim(device="cpu")


@pytest.mark.parametrize("collider", ["ground", "sphere", "capsule", "hull", "box"])
def test_substep_matches_jax(pedestals, collider):
    jsim, sim = pedestals
    jw = jsim.scene.soft
    bp, bq = np.array(jsim.state.body_pos), np.array(jsim.state.body_quat)
    world, pos, vel = substep_inputs(jw, bp, np.asarray(jsim.params.shape_pos),
                                     np.asarray(jsim.params.shape_size), collider)
    js = jsoft.SoftStepper(world, jsim.scene)
    ts = soft.SoftStepper(world, sim.scene, "cpu")
    js.iters = ts.iters = SUBSTEP_ITERS
    js.has_ground = ts.has_ground = collider == "ground"
    h = sim.stepper.h
    with jax.disable_jit():
        want = js.substep(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(bp), jnp.asarray(bq),
                          jsim.params, h, jsim.params.gravity)
    got = ts.substep(torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(bp),
                     torch.as_tensor(bq), sim.params, h, sim.params.gravity)
    for name, a, b in zip(("pos", "vel"), got, want):
        scale = float(np.abs(np.asarray(b)).max())
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err <= FN_TOL * scale, f"{collider} {name}: {err:.3e} > {FN_TOL} * {scale:.3g}"
    # the collider acted: without it the substep ends elsewhere
    bare = soft.SoftStepper(alone(jw, None), sim.scene, "cpu")
    bare.iters, bare.has_ground = SUBSTEP_ITERS, False
    free = bare.substep(torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(bp),
                        torch.as_tensor(bq), sim.params, h, sim.params.gravity)
    assert float((got[0] - free[0]).abs().max()) > 1e-2


def test_stress_normals_and_det_match_jax(pedestals):
    jsim, sim = pedestals
    pos, _ = deformed_state(jsim.scene.soft, np.array([0.0, 0.0, 3.0], np.float32), seed=5)
    js, ts = jsim.stepper.soft, sim.stepper.soft
    want = np.asarray(jax.jit(js.tet_stress)(jnp.asarray(pos), jsim.params))
    got = ts.tet_stress(torch.as_tensor(pos), sim.params).numpy()
    assert got.shape == want.shape == (1, sim.scene.soft.num_tets, 3, 3)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= FN_TOL * scale, (err, scale)
    assert np.abs(got - np.swapaxes(got, -1, -2)).max() < 1e-2
    n_want = np.asarray(jax.jit(js.tri_normals)(jnp.asarray(pos)))
    n_got = ts.tri_normals(torch.as_tensor(pos)).numpy()
    close(n_got, n_want, "tri_normals", tol=FN_TOL)
    np.testing.assert_allclose(np.linalg.norm(n_got, axis=-1), 1.0, atol=1e-5)
    ft = ts.deformation(torch.as_tensor(pos))
    det_want = np.asarray(jnp.linalg.det(jnp.swapaxes(jnp.asarray(ft.numpy()), -1, -2)))
    assert np.abs(soft._det_rows(ft).numpy() - det_want).max() < 1e-6


# ---------------------------------------------------------------------------
# state handling

def _step_both(jsim, sim, js, s, steps, what, actions=None):
    """Step the jitted JAX Simulator and the port `steps` times from js, s,
    holding soft_pos and the rigid state at the goldens' rule each step."""
    ja = jsim.actions if actions is None else actions[0]
    ta = sim.actions if actions is None else actions[1]
    step = jax.jit(jsim.stepper.step)
    for k in range(1, steps + 1):
        js = step(js, ja, jsim.params)
        s = sim.stepper.step(s, ta, sim.params)
        got = to_numpy(s)
        for f in ("soft_pos",) + RIGID_FIELDS:
            close(got[f], np.asarray(getattr(js, f)), f"{what} {f} after {k} steps", tol=STEP_TOL)
    return js, s


def test_reset_restores_soft_state():
    sim = sb.soft_body_sim(2, device="cpu")
    sim.rollout(3)
    assert float((sim.state.soft_pos - sim.initial_state.soft_pos).abs().max()) > 1e-3
    moved = sim.state
    sim.reset()
    assert torch.equal(sim.state.soft_pos, sim.initial_state.soft_pos)
    assert torch.equal(sim.state.soft_vel, sim.initial_state.soft_vel)
    sim.state = moved
    sim.reset(np.array([True, False]))
    assert torch.equal(sim.state.soft_pos[0], sim.initial_state.soft_pos[0])
    assert torch.equal(sim.state.soft_pos[1], moved.soft_pos[1])
    assert torch.equal(sim.state.soft_vel[1], moved.soft_vel[1])


def test_soft_step_under_debug(monkeypatch):
    from test_isaacgym_tpu_torch.utils import debug

    monkeypatch.setenv("TIG_DEBUG", "1")
    sim = sb.soft_body_sim(2, device="cpu")
    assert sim.stepper.debug and sim.stepper.soft is not None
    st = debug.verify_step_purity(sim.stepper, sim.state, sim.actions, sim.params)
    assert torch.isfinite(st.soft_pos).all()
    assert float((st.soft_pos - sim.state.soft_pos).abs().max()) > 0


def test_from_numpy_carries_jax_soft_state():
    jsim, sim = jax_drop(2), sb.soft_body_sim(2, device="cpu")
    with rolled_scan():
        step = jax.jit(jsim.stepper.step)
        js = step(step(jsim.state, jsim.actions, jsim.params), jsim.actions, jsim.params)
    s = _port_state(js)
    for f in ("soft_pos", "soft_vel"):
        np.testing.assert_array_equal(getattr(s, f).numpy(), np.asarray(getattr(js, f)))
    back = to_numpy(s)
    assert back["soft_pos"].dtype == np.float32 and back["soft_pos"].shape == (2, 195, 3)
    with rolled_scan():
        _step_both(jsim, sim, js, s, 1, "from a JAX state")


# ---------------------------------------------------------------------------
# goldens and the stand-in

def check_golden(path, sim):
    g = np.load(path)
    s = sim.state
    for k in range(len(g["soft_pos"])):
        if k:
            s = sim.stepper.step(s, sim.actions, sim.params)
        close(s.soft_pos.numpy(), g["soft_pos"][k], f"{os.path.basename(path)} step {k}",
              tol=STEP_TOL)
    assert int(g["self_agree"]) >= len(g["soft_pos"]) - 1


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_goldens_reproduced_by_port(golden):
    check_golden(GOLDEN, sb.soft_body_sim(int(golden["num_envs"]), device="cpu"))
    check_golden(PEDESTALS_GOLDEN, sb.pedestals_sim(device="cpu"))


def test_icosphere_standin_is_the_generators(tmp_path):
    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools)
    try:
        import make_icosphere_standin as mk
    finally:
        sys.path.remove(tools)
    n, vmin, valence = mk.write(str(tmp_path))
    for name in (mk.URDF, mk.TET):
        with open(tmp_path / name, "rb") as a, open(os.path.join(sb.STANDIN_ROOT, name), "rb") as b:
            assert a.read() == b.read(), name
    verts, tets = soft.load_tet(str(tmp_path / mk.TET))
    tris, _, _ = soft.surface_triangles(tets)
    assert len(tris) == 320 and len(np.unique(tris)) == 162 and n == len(tets)
    np.testing.assert_allclose(np.linalg.norm(verts[np.unique(tris)], axis=-1), 1.0, atol=1e-6)
    # no star from the centre: every tet's Jacobi scale is well above 1/320
    assert valence < 64 and vmin > 0.1
    asset = sb.icosphere(load_urdf, sb.SOFT_THICKNESS)
    fem = asset.links[-1].fem
    assert (fem.youngs, fem.poissons, fem.origin_pos) == (1e5, 0.45, (0.0, -0.5, 0.0))
    assert asset.dof_names() == ["rail"]


# ---------------------------------------------------------------------------
# the goldens, run as a script

def self_agreement(jsim, steps, actions=None, state=None):
    """(the last step up to which the jitted and op-by-op runs of jsim agree
    on soft_pos within the goldens' rule, the op-by-op soft_pos of steps 0..
    that step: the run whose arithmetic the port follows on both devices,
    without XLA's fused multiply-adds)."""
    actions = jsim.actions if actions is None else actions
    step = jax.jit(jsim.stepper.step)
    a = b = jsim.state if state is None else state
    snaps = [np.asarray(a.soft_pos)]
    for k in range(1, steps + 1):
        a = step(a, actions, jsim.params)
        with jax.disable_jit():
            b = jsim.stepper.step(b, actions, jsim.params)
        err = soft_rel_err(b, a)
        print(f"  step {k}: jitted vs op by op {err:.3e}", flush=True)
        if err > STEP_TOL:
            return k - 1, snaps
        snaps.append(np.asarray(b.soft_pos))
    return steps, snaps


def _horizons():
    """The goldens' snapshots and the stepped tests' horizons."""
    out = {}
    with rolled_scan():
        jsim = jax_drop(GOLDEN_ENVS)
        out["self_agree"], snaps = self_agreement(jsim, 30)
        out["soft_pos"] = np.stack(snaps)
        print(f"soft_body {GOLDEN_ENVS} envs: agree for {out['self_agree']} steps", flush=True)
        ped = jax_pedestals()
        out["ped_self_agree"], snaps = self_agreement(ped, 30)
        out["ped_soft_pos"] = np.stack(snaps)
        print(f"pedestals: agree for {out['ped_self_agree']} steps", flush=True)
        drop = jax_drop(2, **drop_kwargs())
        out["drop_self_agree"], snaps = self_agreement(drop, 30)
        h = snaps[-1][..., 1].max(-1) - snaps[-1][..., 1].min(-1)
        out["drop_height_gap"] = h[1] - h[0]
        print(f"drop: agree for {out['drop_self_agree']} steps; heights {h}", flush=True)
        out["press_self_agree"] = press_agreement()
    return out


def press_agreement():
    with rolled_scan():
        press = jax_drop(1, **press_kwargs())
        agree, _ = self_agreement(press, 30, *press_start(press))
    print(f"press: agree for {agree} steps", flush=True)
    return agree


def _ends(world, pos):
    return pos[..., 1].min(-1), volume_ratio(world, pos)


def _agreement():
    """Lowest vertex and volume ratio of the golden's envs after BIG_STEPS
    steps, jitted and op by op."""
    with rolled_scan():
        jsim = jax_drop(GOLDEN_ENVS)
        a = jax.jit(jsim.stepper.rollout, static_argnums=3)(
            jsim.state, jsim.actions, jsim.params, BIG_STEPS)
        b = jsim.state
        t = time.time()
        with jax.disable_jit():
            for k in range(BIG_STEPS):
                b = jsim.stepper.step(b, jsim.actions, jsim.params)
                if k % 10 == 9:
                    print(f"  op by op: step {k + 1} ({time.time() - t:.0f} s)", flush=True)
    w = jsim.scene.soft
    (la, va), (lb, vb) = _ends(w, np.asarray(a.soft_pos)), _ends(w, np.asarray(b.soft_pos))
    return {"agree_lowest_jit": la, "agree_volume_jit": va,
            "agree_lowest_opbyop": lb, "agree_volume_opbyop": vb}


def _part(x, lo, n=CHUNK):
    """Envs lo..lo+n-1 of a 1024-env state, actions or params tuple."""
    return type(x)(*[v[lo:lo + n] if getattr(v, "ndim", 0) and v.shape[0] == BIG_ENVS
                     else v for v in x])


def _big():
    """Lowest vertex and volume ratio of every env of the 1024-env build
    after BIG_STEPS steps, run CHUNK envs at a time (the envs are
    independent; the chunks keep their env origins)."""
    with rolled_scan():
        big = jax_drop(BIG_ENVS)
        run = jax.jit(big.stepper.rollout, static_argnums=3)
        low, vol = [], []
        t = time.time()
        for lo in range(0, BIG_ENVS, CHUNK):
            end = run(_part(big.state, lo), _part(big.actions, lo), _part(big.params, lo),
                      BIG_STEPS)
            l, v = _ends(big.scene.soft, np.asarray(end.soft_pos))
            low.append(l)
            vol.append(v)
            print(f"  big: envs {lo}-{lo + CHUNK - 1} ({time.time() - t:.0f} s)", flush=True)
    return {"jax_lowest": np.concatenate(low), "jax_volume": np.concatenate(vol)}


def _big_opbyop_chunk(lo):
    """Lowest vertex and volume ratio of envs lo..lo+OPBYOP_CHUNK-1 of the
    1024-env build after BIG_STEPS steps op by op (jax.disable_jit)."""
    with rolled_scan():
        big = jax_drop(BIG_ENVS)
        st, actions, params = (_part(x, lo, OPBYOP_CHUNK)
                               for x in (big.state, big.actions, big.params))
        t = time.time()
        with jax.disable_jit():
            for k in range(BIG_STEPS):
                st = big.stepper.step(st, actions, params)
                if k % 20 == 19:
                    print(f"  op by op, envs {lo}-{lo + OPBYOP_CHUNK - 1}: step {k + 1} "
                          f"({time.time() - t:.0f} s)", flush=True)
    return _ends(big.scene.soft, np.asarray(st.soft_pos))


def big_opbyop():
    """The JAX package's 1024 envs op by op, OPBYOP_CHUNK envs a worker
    process, added to soft_body_standin.npz as jax_lowest_opbyop and
    jax_volume_opbyop beside the jitted run's jax_lowest and jax_volume;
    prints the means chip_smoke.py's soft_body1024 compares (~1.5 h on 8
    cores; the jitted numbers are left as they were)."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(BIG_ENVS // OPBYOP_CHUNK) as pool:
        ends = pool.map(_big_opbyop_chunk, range(0, BIG_ENVS, OPBYOP_CHUNK), chunksize=1)
    low = np.concatenate([e[0] for e in ends])
    vol = np.concatenate([e[1] for e in ends])
    g = dict(np.load(GOLDEN))
    g.update(jax_lowest_opbyop=low, jax_volume_opbyop=vol)
    print(f"soft_body JAX {BIG_ENVS} envs after {BIG_STEPS} steps: mean volume ratio jitted "
          f"{g['jax_volume'].mean():.6f}, op by op {vol.mean():.6f} (difference "
          f"{vol.mean() - g['jax_volume'].mean():.3e}); mean lowest vertex jitted "
          f"{g['jax_lowest'].mean():.6f}, op by op {low.mean():.6f}")
    np.savez_compressed(os.path.abspath(GOLDEN), **g)
    print(f"wrote {os.path.abspath(GOLDEN)}")


def _run(name):
    return {"horizons": _horizons, "agreement": _agreement, "big": _big}[name]()


def main():
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(3) as pool:
        parts = dict(zip(("horizons", "agreement", "big"),
                         pool.map(_run, ("horizons", "agreement", "big"))))
    h, a, b = parts["horizons"], parts["agreement"], parts["big"]
    slack_low = float(np.abs(a["agree_lowest_jit"] - a["agree_lowest_opbyop"]).max())
    slack_vol = float(np.abs(a["agree_volume_jit"] - a["agree_volume_opbyop"]).max())
    print(f"soft_body JAX {BIG_ENVS} envs after {BIG_STEPS} steps: lowest vertex "
          f"{b['jax_lowest'].min():.6f} .. {b['jax_lowest'].max():.6f} (mean "
          f"{b['jax_lowest'].mean():.6f}), volume ratio {b['jax_volume'].min():.6f} .. "
          f"{b['jax_volume'].max():.6f} (mean {b['jax_volume'].mean():.6f}); jitted vs op by op "
          f"at {GOLDEN_ENVS} envs: lowest {slack_low:.3e}, volume {slack_vol:.3e}")
    np.savez_compressed(
        os.path.abspath(GOLDEN), num_envs=GOLDEN_ENVS, self_agree=h["self_agree"],
        soft_pos=h["soft_pos"], drop_self_agree=h["drop_self_agree"],
        drop_height_gap=h["drop_height_gap"], press_self_agree=h["press_self_agree"],
        big_envs=BIG_ENVS, big_steps=BIG_STEPS, **b, **a)
    np.savez_compressed(os.path.abspath(PEDESTALS_GOLDEN), self_agree=h["ped_self_agree"],
                        soft_pos=h["ped_soft_pos"])
    print(f"wrote {os.path.abspath(GOLDEN)} and {os.path.abspath(PEDESTALS_GOLDEN)}")


if __name__ == "__main__":
    big_opbyop() if "--big-opbyop" in sys.argv else main()

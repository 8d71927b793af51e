"""Port parity: convex-hull contact (kinds 10-16) against the JAX package.

  * narrowphase, per hull kind, on 96 seeded pose sets of a scene that
    holds every hull pair: a 16-gon prism "can" and an irregular hull
    (envs/pile.py's meshes, through `create_mesh_asset`), a box, a sphere
    and a capsule (free), a static box, a pendulum chain whose bob is a
    hull (a LINK side), and a ground; shape sizes jittered per env, so the
    hulls scale unevenly. Both hull-hull directions occur, and so do a hull
    on a LINK side and a hull against the static box. Tolerance 1e-5 of
    the largest magnitude of each output;
  * `verify_step_purity` with TIG_DEBUG=1 (the table asserts cover the
    hull rows) on that scene;
  * the hull_pile scene (envs/pile.py: kuka_bin.py's objects, a ground) at
    4 envs, stepped against the JAX Simulator at the goldens' rule
    1e-4 * max(|ref|, 1) for HORIZON steps: as many as the JAX package's
    own jitted and op-by-op steps agree within that rule.

The JAX package's sphere-vs-hull narrowphase indexes its component table
with four subscripts (`pa[:, i0, k, None]`, physics/contacts.py:1270), which
its table class does not take, so a scene with a sphere-hull pair raises
there. `jax_sphere_hull_shim` gives that indexing the meaning it was
written with (component k of rows i0, a trailing unit axis) for the length
of a test, without editing the package.

Run as a script, this regenerates the hull_pile golden that chip_smoke.py
holds the card to (test_isaacgym_tpu_torch/assets/data/hull_pile.npz: 8
envs, every 10th step, up to the JAX package's self-agreement horizon),
and computes the JAX package's lowest object clearance and share of envs
at rest after 120 steps of 4096 envs, which chip_smoke.py bounds:
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_hull.py
"""
import contextlib
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_isaacgym_tpu_torch.core.state import PhysParams, from_numpy, to_numpy  # noqa: E402
from test_isaacgym_tpu_torch.envs import pile  # noqa: E402
from test_torch_contacts import _batch_params, _random_poses, close_rel, rolled_scan  # noqa: E402
from test_torch_kinematics import JAX, PORT, close  # noqa: E402

torch.set_num_threads(1)

HULL_KINDS = tuple(range(10, 17))
STEP_TOL = 1e-4
FIELDS = ("root_pos", "root_quat", "root_linvel", "root_angvel", "contact_force")
# steps the 4-env hull_pile is held to the JAX package for: the JAX
# package's own jitted and op-by-op runs of the 8-env scene agree within
# the goldens' rule for the first 26 steps (`python tests/test_torch_hull.py`
# measures it and stores it in the golden as self_agree), in whole 10s
HORIZON = 20
GOLDEN = os.path.join(os.path.dirname(pile.__file__), "..", "assets", "data", "hull_pile.npz")
GOLDEN_ENVS, GOLDEN_EVERY = 8, 10
BIG_ENVS, BIG_STEPS = 4096, 120  # the chip's hull_pile4096
REST_SPEED = 0.1  # m/s: an env is at rest when every object is slower


@contextlib.contextmanager
def jax_sphere_hull_shim():
    """The JAX package's `_hull_narrowphase` with its side-a position table
    wrapped to take `pa[:, i0, k, None]` as component k of rows i0 with a
    trailing unit axis (see the module docstring)."""
    from test_isaacgym_tpu.physics.contacts import ContactSolver

    original = ContactSolver._hull_narrowphase

    class Key4:
        def __init__(self, table):
            self.table = table

        def __getitem__(self, key):
            if isinstance(key, tuple) and len(key) == 4 and key[3] is None:
                return self.table[key[:3]][..., None]
            return self.table[key]

    def shimmed(self, put, pa, *rest):
        return original(self, put, Key4(pa), *rest)

    ContactSolver._hull_narrowphase = shimmed
    try:
        yield
    finally:
        ContactSolver._hull_narrowphase = original


def _mods(pkg):
    return [importlib.import_module(f"{pkg}.{m}")
            for m in ("assets.primitives", "core.config", "core.scene", "core.sim",
                      "assets.types")]


def _hull_pendulum(t):
    """A fixed base and a revolute bob whose collision shape is a hull (a
    slanted wedge, 6 vertices) 0.15 m below the hinge."""
    wedge = np.array([[-0.05, -0.04, -0.03], [0.05, -0.04, -0.03], [-0.05, 0.04, -0.03],
                      [0.05, 0.04, -0.03], [-0.05, -0.04, 0.04], [0.05, -0.04, 0.02]], np.float32)
    root = t.LinkSpec(name="base", mass=1.0, inertia=np.eye(3) * 1e-2, explicit_inertial=True)
    bob = t.LinkSpec(
        name="bob", parent=0,
        joint=t.JointSpec(name="hinge", jtype="revolute", axis=(0, 1, 0)),
        mass=0.5, com=(0, 0, -0.15), inertia=np.eye(3) * 1e-3, explicit_inertial=True,
        geoms=[t.GeomSpec(t.GEOM_MESH, (), (0, 0, -0.15), vertices=wedge,
                          faces=np.zeros((0, 3), np.int32))],
    )
    return t.AssetSpec(name="pend", links=[root, bob], fix_base_link=True)


def _finalize(pkg, b):
    return b.finalize() if pkg == JAX else b.finalize("cpu")


def hull_zoo(pkg):
    """(scene, state, params) of one env with every hull pair."""
    prim, cfg, sc, _, t = _mods(pkg)
    b = sc.SceneBuilder(cfg.SimParams(dt=1 / 60, substeps=2))
    b.add_ground(cfg.PlaneParams(static_friction=0.6, restitution=0.2))
    b.create_env((-1, -1, 0), (1, 1, 1), 1)
    objs = [prim.create_mesh_asset("can", *pile.can_mesh()),
            prim.create_mesh_asset("banana", *pile.banana_mesh()),
            prim.create_box(0.08, 0.06, 0.05), prim.create_sphere(0.04),
            prim.create_capsule(0.025, 0.05)]
    for k, a in enumerate(objs):
        b.create_actor(0, a, pos=(0.3 * k, 0, 0.5), name=f"f{k}")
    b.create_actor(0, prim.create_box(0.1, 0.08, 0.06, fix_base_link=True), pos=(0, 0.5, 0.03),
                   name="table")
    b.create_actor(0, _hull_pendulum(t), pos=(0, -0.5, 0.5), name="pend")
    return _finalize(pkg, b)


def _solver(pkg, scene):
    cs = importlib.import_module(f"{pkg}.physics.contacts").ContactSolver
    return cs(scene) if pkg == JAX else cs(scene, device="cpu")


@pytest.fixture(scope="module")
def narrowphase_run():
    jscene, _, jparams = hull_zoo(JAX)
    scene, _, _ = hull_zoo(PORT)
    jc, c = _solver(JAX, jscene), _solver(PORT, scene)
    pos, quat = _random_poses(jscene.num_bodies_per_env, seed=15)
    p = _batch_params(jparams, len(pos), np.random.RandomState(16))
    jp = type(jparams)(**{k: None if v is None else jnp.asarray(v) for k, v in p.items()})
    with jax_sphere_hull_shim():  # op by op, as test_torch_contacts.py's narrowphase
        want = jc.narrowphase(jnp.asarray(pos), jnp.asarray(quat), jp)
    got = c.narrowphase(torch.as_tensor(pos), torch.as_tensor(quat),
                        from_numpy(p, PhysParams, "cpu"))
    return jc, [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_zoo_holds_every_hull_pair(narrowphase_run):
    jc = narrowphase_run[0]
    kinds = set(jc.job.kind.tolist())
    assert set(HULL_KINDS) <= kinds, kinds
    hull = np.isin(jc.job.kind, HULL_KINDS)
    link = 1  # T_LINK
    assert (hull & ((jc.job.a.type == link) | (jc.job.b.type == link))).any()
    static = 2  # T_STATIC
    for kind in (11, 12):  # hull against the static box
        assert ((jc.job.kind == kind) & (jc.job.b.type == static)).any(), kind


@pytest.mark.parametrize("kind", HULL_KINDS)
def test_hull_narrowphase_matches_jax(narrowphase_run, kind):
    jc, want, got = narrowphase_run
    rows = np.nonzero(jc.job.kind == kind)[0]
    assert len(rows)
    for name, w, g in zip(("point", "normal", "depth"), want, got):
        w, g = w[:, rows], g[:, rows]
        if kind == 11 and name == "normal":
            # a hull vertex just outside the box: its normal is the unit
            # direction to the box's surface, which carries the two
            # packages' last-bit difference in the vertex (torch's cross
            # product contracts to fused multiply-adds, the JAX package's
            # op-by-op component form does not) divided by the distance;
            # held where the vertex is 2 mm or more away, or inside
            near = (want[2][:, rows] <= 0) & (want[2][:, rows] > -2e-3)
            g = np.where(near[..., None], w, g)
        close_rel(g, w, f"kind {kind} {name}")
    off = jc.scene.sim_params.physx.contact_offset
    differ = want[3][:, rows] != got[3][:, rows]
    assert not (differ & (np.abs(want[2][:, rows] + off) > 1e-5)).any(), f"kind {kind} active"
    assert (want[2][:, rows] > 0).any(), f"kind {kind}: no penetrating row"
    if kind == 16:  # both capsule ends touch in some pose
        slot = jc.job.slot[rows]
        assert all((want[2][:, rows][:, slot == s] > 0).any() for s in (0, 1))


def test_hull_step_under_debug(monkeypatch):
    """TIG_DEBUG=1: the contact-table asserts run on a table with hull rows,
    and the step is pure and repeatable."""
    monkeypatch.setenv("TIG_DEBUG", "1")
    from test_isaacgym_tpu_torch.core.sim import Simulator
    from test_isaacgym_tpu_torch.utils import debug

    sim = Simulator(*hull_zoo(PORT), device="cpu")
    assert sim.stepper.debug and set(HULL_KINDS) <= set(sim.stepper.contact.job.kind.tolist())
    st = debug.verify_step_purity(sim.stepper, sim.state, sim.actions, sim.params)
    assert torch.isfinite(st.root_pos).all()


def pile_sim(pkg, env_ids, terrain=None, device="cpu"):
    """A Simulator of envs `env_ids` of envs/pile.py's grid in package pkg."""
    prim, cfg, sc, sm, _ = _mods(pkg)
    b = sc.SceneBuilder(pile.pile_params(cfg))
    pile.build(b, cfg, pile.pile_assets(prim), env_ids, terrain=terrain)
    if pkg == JAX:
        return sm.Simulator(*b.finalize())
    return sm.Simulator(*b.finalize(device), device=device)


def test_hull_pile_steps_like_jax():
    jsim, sim = pile_sim(JAX, range(4)), pile_sim(PORT, range(4))
    c = sim.stepper.contact
    assert c.num_contacts == jsim.stepper.contact.num_contacts == 53
    assert set(HULL_KINDS) <= set(c.job.kind.tolist())
    js, s = jsim.state, sim.state
    with jax_sphere_hull_shim(), rolled_scan():
        step = jax.jit(jsim.stepper.step)
        for k in range(1, HORIZON + 1):
            js = step(js, jsim.actions, jsim.params)
            s = sim.stepper.step(s, sim.actions, sim.params)
            if k % 10 == 0:
                got = to_numpy(s)
                for f in FIELDS:
                    close(got[f], np.asarray(getattr(js, f)), f"hull_pile {f} after {k} steps",
                          tol=STEP_TOL)
    assert np.abs(np.asarray(js.contact_force)).max() > 0


def check_golden_on_port(path, terrain=None):
    """The committed pile golden at `path` (made by the JAX package) on the
    port's own build of its envs, every GOLDEN_EVERY steps, at the goldens'
    rule; the golden ends within the JAX package's self-agreement."""
    golden = np.load(path)
    sim = pile_sim(PORT, [int(k) for k in golden["env_ids"]], terrain)
    s = sim.state
    for i in range(len(golden["root_pos"])):
        if i:
            s = sim.stepper.rollout(s, sim.actions, sim.params, GOLDEN_EVERY)
        for f in ("root_pos", "root_quat"):
            close(getattr(s, f).numpy(), golden[f][i], f"{f} at step {GOLDEN_EVERY * i}",
                  tol=STEP_TOL)
    assert int(golden["self_agree"]) >= GOLDEN_EVERY * (len(golden["root_pos"]) - 1)
    return sim


def test_hull_golden_reproduced_by_port():
    check_golden_on_port(GOLDEN)


# ---------------------------------------------------------------------------
# the golden, run as a script

def rel_err(a, b):
    """max |a - b| / max(|b|, 1) over root pose and velocity."""
    return max(float(np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f))).max())
               / max(float(np.abs(np.asarray(getattr(b, f))).max()), 1.0)
               for f in ("root_pos", "root_quat", "root_linvel", "root_angvel"))


def self_agreement(jsim, steps):
    """The last step up to which the JAX package's jitted and op-by-op
    (jax.disable_jit) runs of jsim agree within the goldens' rule."""
    step = jax.jit(jsim.stepper.step)
    a = b = jsim.state
    for k in range(1, steps + 1):
        a = step(a, jsim.actions, jsim.params)
        with jax.disable_jit():
            b = jsim.stepper.step(b, jsim.actions, jsim.params)
        err = rel_err(b, a)
        print(f"  step {k}: jitted vs op by op {err:.3e}", flush=True)
        if err > STEP_TOL:
            return k - 1
    return steps


def golden_run(jsim, steps, every):
    """root_pos and root_quat of jsim every `every` steps, 0..steps."""
    step = jax.jit(jsim.stepper.step)
    s, out = jsim.state, {"root_pos": [], "root_quat": []}
    for k in range(steps + 1):
        if k % every == 0:
            for f in out:
                out[f].append(np.asarray(getattr(s, f)))
        if k < steps:
            s = step(s, jsim.actions, jsim.params)
    return {f: np.stack(v) for f, v in out.items()}, s


def end_bounds(sim_or_jsim, state):
    """(lowest clearance of any object over all envs, share of envs whose
    objects all move slower than REST_SPEED) of a pile state."""
    c = sim_or_jsim.stepper.contact
    depth = np.asarray(c.narrowphase(state.body_pos, state.body_quat, sim_or_jsim.params)[2])
    speed = np.linalg.norm(np.asarray(state.root_linvel), axis=-1)
    return float(pile.ground_clearance(c, depth).min()), float((speed < REST_SPEED).all(1).mean())


def main():
    with jax_sphere_hull_shim(), rolled_scan():
        small = pile_sim(JAX, range(GOLDEN_ENVS))
        agree = self_agreement(small, BIG_STEPS)
        steps = agree // GOLDEN_EVERY * GOLDEN_EVERY
        print(f"hull_pile {GOLDEN_ENVS} envs: jitted and op-by-op JAX steps agree for {agree} "
              f"steps; golden every {GOLDEN_EVERY} steps to step {steps}", flush=True)
        golden, _ = golden_run(small, steps, GOLDEN_EVERY)
        big = pile_sim(JAX, range(BIG_ENVS))
        _, end = golden_run(big, BIG_STEPS, BIG_STEPS)
        lowest, rest = end_bounds(big, end)
    print(f"hull_pile JAX {BIG_ENVS} envs after {BIG_STEPS} steps: lowest clearance "
          f"{lowest:.6f} m, share at rest {rest:.6f}")
    np.savez_compressed(os.path.abspath(GOLDEN), **golden, env_ids=np.arange(GOLDEN_ENVS),
                        self_agree=agree, jax_lowest=lowest, jax_rest_share=rest)
    print(f"wrote {os.path.abspath(GOLDEN)}")


if __name__ == "__main__":
    main()

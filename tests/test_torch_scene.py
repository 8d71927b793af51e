"""Port parity of the host build: scene tables, initial state, contact rows.

The same builder calls go to both packages' SceneBuilder. The scene tables
are numpy in both and must be equal; the initial SimState / PhysParams must
be equal element for element and dtype for dtype; the port's ContactSolver
must build the JAX package's candidate-contact row table and fast-path
specs.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from test_isaacgym_tpu_torch.core.state import PhysParams, SimState, from_numpy, to_numpy

JAX_PKG, PORT = "test_isaacgym_tpu", "test_isaacgym_tpu_torch"


def _mods(pkg):
    imp = lambda m: __import__(f"{pkg}.{m}", fromlist=["x"])  # noqa: E731
    return imp("assets.primitives"), imp("core.config"), imp("core.scene")


def _balls_builder(pkg):
    """The BallsEnv scene (4 pyramids) through the builder directly."""
    prim, config, scene = _mods(pkg)
    sp = config.SimParams(dt=1 / 60, substeps=1)
    b = scene.SceneBuilder(sp)
    b.add_ground(config.PlaneParams())
    ball = prim.create_sphere(0.2, density=500.0)
    b.create_env((-8, -8, 0), (8, 8, 8), 1)
    rng = np.random.RandomState(17)
    for k in range(120):
        b.create_actor(0, ball, pos=(rng.uniform(-3, 3), rng.uniform(-3, 3), 1 + k * 0.01),
                       name=f"ball{k}", group=0, filter=0)
    return b


def _prims_builder(pkg):
    """Spheres, boxes, capsules and a static actor on a ground, 2 envs."""
    prim, config, scene = _mods(pkg)
    b = scene.SceneBuilder(config.SimParams())
    b.add_ground(config.PlaneParams(static_friction=0.7, restitution=0.1))
    sphere = prim.create_sphere(0.1, density=300.0)
    box = prim.create_box(0.2, 0.3, 0.1, angular_damping=0.4)
    cap = prim.create_capsule(0.05, 0.1)
    table = prim.create_box(1.0, 1.0, 0.1, fix_base_link=True)
    for e in range(2):
        b.create_env((-1, -1, 0), (1, 1, 1), 2)
        b.create_actor(e, table, pos=(0, 0, 0.05), name="table", group=e, filter=0)
        b.create_actor(e, sphere, pos=(0.1, 0, 0.5), name="s", group=e, filter=0)
        b.create_actor(e, box, pos=(-0.2, 0, 0.6), quat=(0, 0, 0.3826834, 0.9238795),
                       name="b", group=e, filter=2)
        b.create_actor(e, cap, pos=(0.3, 0.2, 0.4), name="c", group=e, filter=2)
        b.create_actor(e, sphere, pos=(0, 0.3, 0.3), name="s2", group=-1, filter=0)
    return b


def _mixed_builder(pkg):
    """>= 64 single-shape boxes and spheres: the neighbor-world fast path."""
    prim, config, scene = _mods(pkg)
    b = scene.SceneBuilder(config.SimParams())
    b.add_ground(config.PlaneParams())
    box, ball = prim.create_box(0.1, 0.1, 0.1), prim.create_sphere(0.05)
    b.create_env((-2, -2, 0), (2, 2, 2), 1)
    for k in range(70):
        b.create_actor(0, box if k % 3 == 0 else ball, pos=(k % 10 * 0.2, k // 10 * 0.2, 0.5))
    return b


BUILDERS = {"balls": _balls_builder, "prims": _prims_builder, "mixed": _mixed_builder}


def _eq(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            if f.name != "asset":  # each package has its own AssetSpec class
                _eq(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _eq(a[k], b[k], f"{what}[{k}]")
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_scene_tables_match_jax(name):
    jscene, _, _ = BUILDERS[name](JAX_PKG).finalize()
    scene, _, _ = BUILDERS[name](PORT).finalize("cpu")
    for f in dataclasses.fields(jscene):
        if f.name in ("sim_params", "ground", "soft"):
            continue
        _eq(getattr(scene, f.name), getattr(jscene, f.name), f.name)
    assert dataclasses.asdict(scene.sim_params) == dataclasses.asdict(jscene.sim_params)
    assert dataclasses.asdict(scene.ground) == dataclasses.asdict(jscene.ground)
    assert scene.soft is None and jscene.soft is None


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_initial_state_and_params_match_jax(name):
    _, jstate, jparams = BUILDERS[name](JAX_PKG).finalize()
    _, state, params = BUILDERS[name](PORT).finalize("cpu")
    for got, want in ((state, jstate), (params, jparams)):
        assert type(got)._fields == type(want)._fields
        for f, g in zip(got._fields, got):
            w = getattr(want, f)
            if w is None:
                assert g is None, f
                continue
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu", f
            _eq(g.numpy(), np.asarray(w), f)


def test_contact_row_table_matches_jax():
    from test_isaacgym_tpu.physics.contacts import ContactSolver as JaxSolver
    from test_isaacgym_tpu_torch.physics.contacts import ContactSolver

    for name in sorted(BUILDERS):
        jc = JaxSolver(BUILDERS[name](JAX_PKG).finalize()[0])
        c = ContactSolver(BUILDERS[name](PORT).finalize("cpu")[0])
        assert c.num_contacts == jc.num_contacts, name
        assert c.enabled == jc.enabled, name
        _eq(c.link_lists, jc.link_lists, f"{name} link_lists")
        assert c.any_link == jc.any_link
        if jc.num_contacts:
            for side in ("a", "b"):
                _eq(list(getattr(c.job, side)), list(getattr(jc.job, side)), f"{name} job.{side}")
            for f in ("kind", "shape_a", "shape_b", "slot"):
                _eq(getattr(c.job, f), getattr(jc.job, f), f"{name} job.{f}")
        for fast in ("sphere_world", "neighbor_world"):
            js, ps = getattr(jc, fast), getattr(c, fast)
            assert (js is None) == (ps is None), f"{name} {fast}"
            if js is not None:
                for f in js._fields:
                    _eq(getattr(ps, f), getattr(js, f), f"{name} {fast}.{f}")
    # the primitives scene has rows; the balls and mixed scenes route to a
    # fast path and build none
    assert JaxSolver(_prims_builder(JAX_PKG).finalize()[0]).num_contacts > 0


def test_balls_scene_routes_to_the_sphere_world():
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv

    c = BallsEnv(num_worlds=1, pyramids=4, device="cpu").sim.stepper.contact
    assert c.sphere_world is not None and len(c.sphere_world.shape_idx) == 120
    assert c.num_contacts == 0 and c.enabled


def test_unported_paths_raise(monkeypatch):
    from test_isaacgym_tpu_torch.assets import sdf
    from test_isaacgym_tpu_torch.assets.types import FemSpec
    from test_isaacgym_tpu_torch.core.sim import Simulator

    # SDF contact is ported (the name is the test's from before; the hull
    # and heightfield contact it refused earlier step in
    # tests/test_torch_hull.py and tests/test_torch_terrain.py): a URDF
    # mesh that asks for SDF collision loads with a grid and probes
    prim, config, scene = _mods(PORT)
    from test_isaacgym_tpu_torch.assets import load_urdf

    tmp = tempfile.mkdtemp()
    monkeypatch.setattr(sdf, "_CACHE_DIR", os.path.join(tmp, "sdf_cache"))
    with open(os.path.join(tmp, "part.obj"), "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n")
    with open(os.path.join(tmp, "part.urdf"), "w") as f:
        f.write('<robot name="p"><link name="a"><collision><geometry><mesh filename="part.obj"/>'
                '</geometry><sdf resolution="64"/></collision></link></robot>')
    g = load_urdf(tmp, "part.urdf").links[0].geoms[0]
    assert g.sdf.data.shape == (sdf.SDF_RES,) * 3 and g.sdf_samples.shape == (256, 3)
    # and a mesh pair where one side carries an SDF (K_PT_SDF rows) steps
    verts = np.array([[x, y, z] for x in (-0.1, 0.1) for y in (-0.1, 0.1) for z in (-0.1, 0.1)])
    faces = np.zeros((0, 3), np.int32)
    field = sdf.sdf_from_fn(lambda p: np.abs(p).max(-1) - 0.1, verts.min(0), verts.max(0))
    b = scene.SceneBuilder(config.SimParams())
    b.create_env((-1, -1, 0), (1, 1, 1), 1)
    b.create_actor(0, prim.create_mesh_asset("probe", verts, faces), pos=(0, 0, 0.5))
    b.create_actor(0, prim.create_mesh_asset("field", verts, faces, sdf=field))
    sim = Simulator(*b.finalize("cpu"), device="cpu")
    assert 17 in sim.stepper.contact.job.kind
    sim.rollout(5)
    assert torch.isfinite(sim.state.root_pos).all()
    # the neighbor-list solve is ported (the name is the test's from before):
    # the mixed world steps, its boxes and spheres falling onto the ground
    sim = Simulator(*_mixed_builder(PORT).finalize("cpu"), device="cpu")
    sim.rollout(40)
    z = sim.state.root_pos[0, :, 2]
    assert torch.isfinite(sim.state.root_pos).all() and 0.0 < float(z.min()) < 0.1
    # soft bodies are ported too: a <fem> link finalizes to the JAX
    # package's soft world and steps (tests/test_torch_soft.py holds the
    # solve)
    from test_isaacgym_tpu.assets.types import FemSpec as JaxFemSpec

    verts = np.array([[0, 0, 0], [0.2, 0, 0], [0, 0.2, 0], [0, 0, 0.2]], np.float32)
    built = []
    for pkg, spec in ((JAX_PKG, JaxFemSpec), (PORT, FemSpec)):
        prim_p, config_p, scene_p = _mods(pkg)
        ball = prim_p.create_sphere(0.1)
        ball.links[0].fem = spec(verts=verts, tets=np.array([[0, 1, 2, 3]], np.int32))
        b = scene_p.SceneBuilder(config_p.SimParams())
        b.add_ground(config_p.PlaneParams())
        b.create_env((-1, -1, 0), (1, 1, 1), 1)
        b.create_actor(0, ball, pos=(0, 0, 0.5))
        built.append(b.finalize() if pkg == JAX_PKG else b.finalize("cpu"))
    (jscene, jstate, _), (tscene, tstate, _) = built
    for f in ("verts0", "tets", "inv_dm", "rest_vol", "inv_mass", "col_kind"):
        np.testing.assert_allclose(getattr(tscene.soft, f), getattr(jscene.soft, f), atol=1e-6)
    np.testing.assert_array_equal(tstate.soft_pos.numpy(), np.asarray(jstate.soft_pos))
    sim = Simulator(*built[1], device="cpu")
    sim.rollout(2)
    assert torch.isfinite(sim.state.soft_pos).all()


def test_from_numpy_round_trips_jax_state_and_params():
    from test_isaacgym_tpu.envs.balls import BallsEnv as JaxBalls

    jsim = JaxBalls(num_worlds=2, pyramids=3).sim
    for value, cls in ((jsim.state, SimState), (jsim.params, PhysParams)):
        fields = {k: (None if v is None else np.asarray(v)) for k, v in value._asdict().items()}
        port = from_numpy(fields, cls, "cpu")
        back = to_numpy(port)
        assert back.keys() == fields.keys()
        for k, v in fields.items():
            if v is None:
                assert back[k] is None, k
            else:
                assert back[k].dtype == v.dtype, k
                np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError):
        from_numpy({"not_a_field": np.zeros(1)}, SimState, "cpu")

"""Port parity: the contact table against the JAX package.

Both packages build the same scenes from the same builder calls; inputs are
made with numpy from the RandomState seeds below and fed to both.
  * narrowphase, per kind 0-9, on 96 random pose sets of a scene that holds
    every primitive pair (two spheres, two capsules, two boxes and a static
    box on a ground): box-box face, edge and inside cases and both end
    slots of the capsule kinds are asserted to occur; tolerance 1e-5 of the
    largest magnitude of each output;
  * `ContactSolver.solve` with FREE-only, FREE + STATIC and FREE + LINK
    tables (two copies of a one-dof platform and a floating-base pendulum
    with a capsule bob: link-link, link-free and two groups of different
    nv), cold and warm started, on random velocities, masses, inertias,
    Jacobians and implicit operators; tolerance 1e-5 of the largest
    magnitude of each output;
  * stepped scenes against the JAX Simulator at the goldens' rule,
    1e-4 * max(|ref|, 1), every field of the state: a ball and a box coming
    to rest on the plane (90 steps), the collision filter (40), the 2-env
    ball pyramid of tests/test_stacks.py (60), the uniform 5-box stack with
    warm start on (25: see SCENES), and the lifting-platform and
    box-dragged scenes of tests/test_link_contacts.py (90 each);
  * `max_pair_shapes`: both packages refuse the same oversized table and
    take it with the limit raised.
The JAX side runs its Jacobi scan rolled (`rolled_scan`): XLA:CPU then
compiles the iteration once instead of once per iteration; the iterations
and their order are the same.
"""
import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_isaacgym_tpu_torch.core.state import PhysParams, from_numpy, to_numpy
from test_torch_kinematics import JAX, PORT, close

# Every pytest-xdist worker imports this module when it collects. The port's
# tensors in these tests are a few envs wide, and with torch's default of one
# OpenMP thread a core the workers' idle threads spin against each other:
# the torch tests took 3.4x the wall time under `-n 6` on 8 cores. One
# intra-op thread a worker process.
torch.set_num_threads(1)

TOL = 1e-5
STEP_TOL = 1e-4
FIELDS = ("root_pos", "root_quat", "root_linvel", "root_angvel", "dof_pos", "dof_vel",
          "body_pos", "body_quat", "contact_force", "warm_n", "warm_t")


@contextlib.contextmanager
def rolled_scan():
    """Trace the JAX package's `lax.scan` calls with unroll=1 (the contact
    solve unrolls its Jacobi loop up to 24 iterations): the same iterations
    in the same order, compiled once each by XLA:CPU."""
    scan = jax.lax.scan

    def rolled(f, init, xs=None, length=None, reverse=False, unroll=1, **kw):
        return scan(f, init, xs, length=length, reverse=reverse, unroll=1, **kw)

    jax.lax.scan = rolled
    try:
        yield
    finally:
        jax.lax.scan = scan


def close_rel(got, want, what):
    """|got - want| <= TOL * the largest magnitude of want."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max |err| {err:.3e} > {TOL} * {scale:.3g}"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _finalize(pkg, b):
    return b.finalize() if pkg == JAX else b.finalize("cpu")


def _solver(pkg, scene, **kw):
    cs = _mod(pkg, "physics.contacts").ContactSolver
    return cs(scene, **kw) if pkg == JAX else cs(scene, device="cpu", **kw)


def _numpy(value):
    return {k: None if v is None else np.asarray(v) for k, v in value._asdict().items()}


# ---------------------------------------------------------------------------
# scenes

def _zoo(pkg, ground=True, static=True, free=True, links=False):
    """Primitive shapes in one env: two spheres, two capsules, two boxes
    (free), a static box, a ground; optionally two platform copies and a
    floating pendulum with a capsule bob (links)."""
    prim, config, scene = (_mod(pkg, m) for m in ("assets.primitives", "core.config", "core.scene"))
    b = scene.SceneBuilder(config.SimParams(dt=1 / 60, substeps=2))
    if ground:
        b.add_ground(config.PlaneParams(static_friction=0.6, restitution=0.2))
    b.create_env((-1, -1, 0), (1, 1, 1), 1)
    if free:
        shapes = [prim.create_sphere(0.1, density=300.0), prim.create_sphere(0.07),
                  prim.create_capsule(0.05, 0.1), prim.create_capsule(0.04, 0.08, density=500.0),
                  prim.create_box(0.2, 0.15, 0.1, density=200.0), prim.create_box(0.12, 0.12, 0.12)]
        for k, a in enumerate(shapes):
            b.create_actor(0, a, pos=(0.3 * k, 0, 0.5), name=f"f{k}")
    if static:
        b.create_actor(0, prim.create_box(0.3, 0.2, 0.1, fix_base_link=True),
                       pos=(0, 0.5, 0.05), name="table")
    if links:
        plat = _platform(pkg, (0, 0, 1))
        for k in range(2):
            b.create_actor(0, plat, pos=(k - 0.5, -0.5, 0.5), name=f"plat{k}")
        b.create_actor(0, _capsule_pendulum(pkg), pos=(0, -0.8, 1.0), name="pend")
    return _finalize(pkg, b)


def _platform(pkg, axis, size=(0.5, 0.5, 0.05)):
    """tests/test_link_contacts.py::_platform_asset: a fixed base and one
    prismatic dof moving a flat box link."""
    t = _mod(pkg, "assets.types")
    base = t.LinkSpec(name="base")
    t.compute_default_inertia(base, 1000.0)
    plat = t.LinkSpec(
        name="platform", parent=0,
        joint=t.JointSpec(name="lift", jtype="prismatic", axis=axis, has_limits=True,
                          lower=-2.0, upper=2.0, effort=1e5, velocity=10.0,
                          stiffness=2e4, damping=2e3, drive_mode=t.DOF_MODE_POS),
        geoms=[t.GeomSpec(kind=t.GEOM_BOX, size=size, friction=1.0)],
    )
    t.compute_default_inertia(plat, 1000.0)
    return t.AssetSpec(name="platform", links=[base, plat], fix_base_link=True)


def _capsule_pendulum(pkg):
    """A floating base with a revolute bob carrying a capsule (nv = 7)."""
    t = _mod(pkg, "assets.types")
    root = t.LinkSpec(name="base", mass=1.0, inertia=np.eye(3) * 1e-2, explicit_inertial=True)
    bob = t.LinkSpec(
        name="bob", parent=0,
        joint=t.JointSpec(name="hinge", jtype="revolute", axis=(0, 1, 0)),
        mass=2.0, com=(0, 0, -0.3), inertia=np.eye(3) * 1e-3, explicit_inertial=True,
        geoms=[t.GeomSpec(t.GEOM_CAPSULE, (0.06, 0.12), (0, 0, -0.3))],
    )
    return t.AssetSpec(name="pend", links=[root, bob], fix_base_link=False)


# ---------------------------------------------------------------------------
# narrowphase

N_POSES = 96


def _random_poses(B, seed=5, spread=0.12):
    """96 pose sets of B bodies in a cube of half-width `spread`: a third
    with random orientations, a third axis-aligned (face contacts), a third
    with random yaw only."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, (N_POSES, B, 3)).astype(np.float32)
    pos[..., 2] += spread
    q = rng.normal(size=(N_POSES, B, 4))
    third = N_POSES // 3
    q[third:2 * third] = [0, 0, 0, 1]
    yaw = rng.uniform(-np.pi, np.pi, (third, B))
    q[2 * third:] = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return pos, q.astype(np.float32)


def _batch_params(params, n, rng):
    """The scene's params for n envs: shape sizes jittered, friction and
    restitution drawn per env."""
    p = _numpy(params)
    out = {}
    for k, v in p.items():
        if v is not None and v.ndim and v.shape[0] == params.shape_size.shape[0]:
            v = np.repeat(v[:1], n, 0)
        out[k] = v
    out["shape_size"] = (out["shape_size"] * rng.uniform(0.8, 1.2, out["shape_size"].shape)
                         ).astype(np.float32)
    out["shape_friction"] = rng.uniform(0.2, 1.0, out["shape_friction"].shape).astype(np.float32)
    out["shape_restitution"] = rng.uniform(0.0, 0.6, out["shape_friction"].shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def narrowphase_run():
    jscene, _, jparams = _zoo(JAX)
    scene, _, _ = _zoo(PORT)
    jc, c = _solver(JAX, jscene), _solver(PORT, scene)
    pos, quat = _random_poses(jscene.num_bodies_per_env)
    p = _batch_params(jparams, N_POSES, np.random.RandomState(6))
    jp = type(jparams)(**{k: None if v is None else jnp.asarray(v) for k, v in p.items()})
    # op by op, not jitted: XLA's fusions round differently, and in
    # degenerate rows (a capsule end inside a box, where the JAX package's
    # normal is the direction of a rounding residue) that changes the
    # result by O(1); op by op both packages round alike
    want = jc.narrowphase(jnp.asarray(pos), jnp.asarray(quat), jp)
    got = c.narrowphase(torch.as_tensor(pos), torch.as_tensor(quat), from_numpy(p, PhysParams, "cpu"))
    return jc, [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("kind", range(10))
def test_narrowphase_matches_jax(narrowphase_run, kind):
    jc, want, got = narrowphase_run
    rows = np.nonzero(jc.job.kind == kind)[0]
    assert len(rows), f"kind {kind} has no rows in the zoo scene"
    for name, w, g in zip(("point", "normal", "depth"), want, got):
        close_rel(g[:, rows], w[:, rows], f"kind {kind} {name}")
    # `active` may differ only where depth sits on the threshold
    off = jc.scene.sim_params.physx.contact_offset
    differ = want[3][:, rows] != got[3][:, rows]
    assert not (differ & (np.abs(want[2][:, rows] + off) > TOL)).any(), f"kind {kind} active"
    # the cases the criteria name occur in these poses
    depth = want[2][:, rows]
    assert (depth > 0).any(), f"kind {kind}: no penetrating row"
    slot = jc.job.slot[rows]
    if kind in (1, 7):  # capsule end slots
        assert all((depth[:, slot == s] > 0).any() for s in (0, 1)), "an end slot never touches"
    if kind == 8:  # box-box face manifold: corners of a and of b
        assert (depth[:, slot < 8] > 0).any() and (depth[:, slot >= 8] > 0).any()
        # and corners past the reference box's centre plane (inside it;
        # the sizes are jittered by up to 1.2)
        ref = np.where(slot < 8, jc.job.shape_b[rows], jc.job.shape_a[rows])
        half = np.asarray(jc.scene.shapes.size)[ref].min(-1)
        assert (depth > half[None] * 1.2).any()
    if kind == 4:  # sphere centre inside the box (the inside branch: depth > r)
        sa = jc.job.shape_a[rows]
        r = np.asarray(jc.scene.shapes.size)[sa, 0]
        assert (depth > r[None] * 0.8 * 1.01).any()


# ---------------------------------------------------------------------------
# solve

# kinds whose normal is the direction between two closest points; where
# those points meet (a capsule end inside a box, coincident centres) the
# JAX package's normal is the direction of a rounding residue
_DIST_KINDS = {3: 2, 5: 2, 6: 2, 7: 1}  # kind: radii in its depth (r_a + r_b or r_a)


def _regular_poses(jc, p, seed, n):
    """n of the random pose sets (spread 0.24 m), and of the params `p`
    (numpy, one env per pose set), in which every row of _DIST_KINDS keeps
    its two closest points at least 1 mm apart, found with the JAX
    narrowphase."""
    pos, quat = _random_poses(jc.scene.num_bodies_per_env, seed, spread=0.24)
    jp = _mod(JAX, "core.state").PhysParams(
        **{k: None if v is None else jnp.asarray(v) for k, v in p.items()})
    depth = np.asarray(jax.jit(jc.narrowphase)(jnp.asarray(pos), jnp.asarray(quat), jp)[2])
    size = p["shape_size"]
    ok = np.ones(len(pos), bool)
    for kind, radii in _DIST_KINDS.items():
        rows = np.nonzero(jc.job.kind == kind)[0]
        r = size[:, jc.job.shape_a[rows], 0]
        if radii == 2:
            r = r + size[:, np.maximum(jc.job.shape_b[rows], 0), 0]
        ok &= ((r - depth[:, rows]) > 1e-3).all(1)
    keep = np.nonzero(ok)[0][:n]
    assert len(keep) == n, f"only {len(keep)} regular pose sets"
    p = {k: v[keep] if v is not None and v.ndim and len(v) == len(pos) else v
         for k, v in p.items()}
    return pos[keep], quat[keep], p


def _solve_inputs(jc, params, seed):
    """Random solve inputs (numpy) for a scene: current poses near each
    other (_regular_poses), velocities, free-body masses and inertias, and
    per group generalized velocities, link Jacobians and SPD inverse
    operators."""
    rng = np.random.RandomState(seed)
    N = 8
    scene = jc.scene
    B = scene.num_bodies_per_env
    pos, quat, p = _regular_poses(jc, _batch_params(params, N_POSES, rng), seed, N)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    x = dict(body_pos=pos, body_quat=quat,
             kin_lin=f32(rng.normal(size=(N, B, 3)) * 0.3),
             kin_ang=f32(rng.normal(size=(N, B, 3)) * 0.5))
    F = scene.free_group.count if scene.free_group is not None else 0
    if F:
        A = rng.normal(size=(N, F, 3, 3)) * 0.01
        x.update(free_v=f32(rng.normal(size=(N, F, 3))), free_w=f32(rng.normal(size=(N, F, 3)) * 2),
                 free_m=f32(rng.uniform(0.2, 3.0, (N, F))),
                 free_I_w=f32(A @ np.swapaxes(A, -1, -2) + np.eye(3) * 0.01),
                 free_com_w=f32(pos[:, scene.free_group.body_slot] + rng.normal(size=(N, F, 3)) * 0.01))
    x["art_qd"], x["art_jac"], x["art_Ainv"] = [], [], []
    for g in scene.art_groups:
        K, Ls = len(g.slots), len(g.body_of_link)
        nv = g.num_dofs + (0 if g.fixed_base else 6)
        A = rng.normal(size=(N, K, nv, nv)) * 0.5
        x["art_qd"].append(f32(rng.normal(size=(N, K, nv))))
        x["art_jac"].append(f32(rng.normal(size=(N, K, Ls, 6, nv)) * 0.3))
        x["art_Ainv"].append(f32(A @ np.swapaxes(A, -1, -2) + np.eye(nv) * 0.2))
    return x, p


def _run_solve(pkg, c, x, p, warm):
    if pkg == JAX:
        t = jnp.asarray
        params = _mod(JAX, "core.state").PhysParams(
            **{k: None if v is None else jnp.asarray(v) for k, v in p.items()})
    else:
        t, params = torch.as_tensor, from_numpy(p, PhysParams, "cpu")
    has_rows = [len(ia) + len(ib) > 0 for ia, ib in c.link_lists]
    opt = lambda k: t(x[k]) if k in x else None  # noqa: E731
    solve = functools.partial(c.solve, h=1 / 120)
    if pkg == JAX:
        solve = jax.jit(solve)
    out = solve(
        t(x["body_pos"]), t(x["body_quat"]), (t(x["kin_lin"]), t(x["kin_ang"])),
        opt("free_v"), opt("free_w"), opt("free_m"), opt("free_I_w"), opt("free_com_w"),
        [t(q) for q in x["art_qd"]],
        [t(j) if r else None for j, r in zip(x["art_jac"], has_rows)],
        [t(a) if r else None for a, r in zip(x["art_Ainv"], has_rows)],
        params, warm=None if warm is None else tuple(t(w) for w in warm),
    )
    fv, fw, qd, cf, (lam_n, lam_t) = out
    arrays = dict(cf=cf, lam_n=lam_n, lam_t=lam_t, **{f"qd{i}": q for i, q in enumerate(qd)})
    if "free_v" in x:
        arrays.update(free_v=fv, free_w=fw)
    return {k: np.asarray(v) if pkg == JAX else v.numpy() for k, v in arrays.items()}


TABLES = {
    "free": dict(ground=False, static=False),
    "free_static": dict(),
    "free_link": dict(ground=False, static=False, links=True),
}


@functools.lru_cache(maxsize=None)
def _solve_case(table):
    """Both packages' solvers of a table, and its inputs (one set for the
    cold and the warm test)."""
    jscene, _, jparams = _zoo(JAX, **TABLES[table])
    scene, _, _ = _zoo(PORT, **TABLES[table])
    jc, c = _solver(JAX, jscene), _solver(PORT, scene)
    return jc, c, _solve_inputs(jc, jparams, seed=11)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_solve_matches_jax(table, warm):
    jc, c, (x, p) = _solve_case(table)
    kinds = {(int(ta), int(tb)) for ta, tb in zip(jc.job.a.type, jc.job.b.type)}
    want_sides = {"free": {(0, 0)}, "free_static": {(0, 0), (0, 2)},
                  "free_link": {(0, 0), (0, 1), (1, 0), (1, 1)}}[table]
    assert kinds == want_sides, kinds
    C = jc.num_contacts
    w = None
    if warm:
        rng = np.random.RandomState(12)
        w = (np.abs(rng.normal(size=(8, C))).astype(np.float32) * 0.01,
             (rng.normal(size=(8, C, 3)) * 0.003).astype(np.float32))
    with rolled_scan():
        want = _run_solve(JAX, jc, x, p, w)
    got = _run_solve(PORT, c, x, p, w)
    assert want.keys() == got.keys()
    for k in want:
        close_rel(got[k], want[k], f"{table} {k}")
    assert np.abs(want["lam_n"]).max() > 0  # some row took an impulse


def test_max_pair_shapes_guard():
    """92 capsules in one env (no fast path takes capsules) make 4,186
    candidate pairs: both packages refuse them under the default limit of
    4,096 and take them with the limit raised."""
    def build(pkg):
        prim, config, scene = (_mod(pkg, m) for m in ("assets.primitives", "core.config",
                                                       "core.scene"))
        b = scene.SceneBuilder(config.SimParams())
        b.create_env((-1, -1, 0), (1, 1, 1), 1)
        cap = prim.create_capsule(0.02, 0.05)
        for k in range(92):
            b.create_actor(0, cap, pos=(k % 10 * 0.1, k // 10 * 0.1, 0.5))
        return _finalize(pkg, b)[0]

    for pkg in (JAX, PORT):
        scene = build(pkg)
        with pytest.raises(ValueError, match="max_pair_shapes"):
            _solver(pkg, scene)
        c = _solver(pkg, scene, max_pair_shapes=5000)
        assert c.num_contacts == 92 * 91 // 2


# ---------------------------------------------------------------------------
# stepped scenes

def _sim(pkg, build):
    config, scene, sim_mod = (_mod(pkg, m) for m in ("core.config", "core.scene", "core.sim"))
    b = build(pkg, config, scene)
    if pkg == JAX:
        return sim_mod.Simulator(*b.finalize())
    return sim_mod.Simulator(*b.finalize("cpu"), device="cpu")


def _rest(pkg, config, scene):
    """tests/test_step.py: a ball (r 0.2) and a box dropped on the plane."""
    prim = _mod(pkg, "assets.primitives")
    b = scene.SceneBuilder(config.SimParams(dt=1 / 60, substeps=2))
    b.add_ground(config.PlaneParams())
    ball, box = prim.create_sphere(0.2, density=1000.0), prim.create_box(0.3, 0.3, 0.3)
    for e in range(2):
        b.create_env((-2, -2, 0), (2, 2, 0), 10)
        b.create_actor(e, ball, pos=(0, 0, 1.0), name="ball", group=e, filter=0)
        b.create_actor(e, box, pos=(1.0, 0, 0.6), quat=(0.1, 0.05, 0.0, 0.9937), name="box",
                       group=e, filter=0)
    return b


def _filtered(pkg, config, scene):
    """tests/test_step.py::test_collision_filter_disables_contact."""
    prim = _mod(pkg, "assets.primitives")
    b = scene.SceneBuilder(config.SimParams(dt=1 / 60, substeps=2))
    b.add_ground(config.PlaneParams())
    b.create_env((-2, -2, 0), (2, 2, 0), 10)
    ball = prim.create_sphere(0.2)
    b.create_actor(0, ball, pos=(0, 0, 0.2), name="a", group=0, filter=1)
    b.create_actor(0, ball, pos=(0, 0, 0.6), name="b", group=0, filter=1)
    return b


def _pyramid(pkg, config, scene):
    """tests/test_stacks.py::_pyramid_scene(num_envs=2)."""
    prim = _mod(pkg, "assets.primitives")
    sp = config.SimParams(dt=1 / 60, substeps=2)
    sp.physx.num_position_iterations = 4
    sp.physx.num_velocity_iterations = 1
    b = scene.SceneBuilder(sp)
    b.add_ground(config.PlaneParams())
    ball = prim.create_sphere(0.2, density=500.0)
    count = 0
    for i in range(2):
        b.create_env((-1.25, -1.25, 0), (1.25, 1.25, 1.25), 1)
        n, spacing = 4, 2.5 * 0.2
        min_coord = -0.5 * (n - 1) * spacing
        z = min_coord + 4 * spacing
        while n > 0:
            y = min_coord
            for _ in range(n):
                x = min_coord
                for _ in range(n):
                    b.create_actor(i, ball, pos=(x, y, 1.5 + z - 4 * spacing + 0.6),
                                   name=f"ball{count}", group=i, filter=0)
                    count += 1
                    x += spacing
                y += spacing
            z += spacing
            n -= 1
            min_coord = -0.5 * (n - 1) * spacing
    return b


def _stack(pkg, config, scene):
    """tests/test_stacks.py::test_uniform_stack_warm_start_low_iters, warm."""
    prim = _mod(pkg, "assets.primitives")
    sp = config.SimParams(dt=1 / 60, substeps=2)
    sp.physx.num_position_iterations = 4
    sp.physx.num_velocity_iterations = 1
    sp.physx.warm_start_contacts = True
    b = scene.SceneBuilder(sp)
    b.add_ground(config.PlaneParams())
    box = prim.create_box(0.5, 0.5, 0.5, density=500.0)
    b.create_env((-2, -2, 0), (2, 2, 4), 1)
    for k in range(5):
        b.create_actor(0, box, pos=(0, 0, 0.25 + 0.502 * k + 0.001), name=f"box{k}",
                       group=0, filter=0)
    return b


def _platform_scene(axis, shape):
    """tests/test_link_contacts.py::_scene."""
    def build(pkg, config, scene):
        prim = _mod(pkg, "assets.primitives")
        b = scene.SceneBuilder(config.SimParams(dt=1 / 60, substeps=2))
        plat = _platform(pkg, axis)
        if shape == "sphere":
            obj = prim.create_sphere(0.1, density=300.0)
        else:
            obj = prim.create_box(0.2, 0.2, 0.2, density=300.0)
        for i in range(2):
            b.create_env((-2, -2, 0), (2, 2, 4), 2)
            b.create_actor(i, plat, pos=(0, 0, 0.5), name="plat", group=i, filter=0)
            b.create_actor(i, obj, pos=(0, 0, 0.66), name="ball", group=i, filter=0)
        return b
    return build


def _lift(jsim, sim):
    for s in (jsim, sim):
        s.set_dof_position_targets(np.full((2, 1), 0.5, np.float32))


def _drag(jsim, sim):
    for s, t in ((jsim, jnp), (sim, torch)):
        s.params = s.params._replace(
            dof_stiffness=t.full_like(s.params.dof_stiffness, 400.0),
            dof_damping=t.full_like(s.params.dof_damping, 400.0),
        )
        s.set_dof_position_targets(np.full((2, 1), 0.4, np.float32))


# name: (build, setup, steps, compare every, check of the JAX end state)
SCENES = {
    "rest": (_rest, None, 90, 30,
             lambda s, sim: np.allclose(np.asarray(s.root_pos)[:, 0, 2], 0.2, atol=0.02)),
    "filter": (_filtered, None, 40, 20,
               lambda s, sim: np.asarray(s.root_pos)[0, 1, 2] < 0.25),
    "pyramid": (_pyramid, None, 60, 20,
                lambda s, sim: (np.asarray(s.root_pos)[..., 2] > 0.19).all()),
    # the stack jitters (its contact force swings between 0 and ~30 kN every
    # few steps, the warm/bias interplay tests/test_stacks.py notes): past
    # step 30 its impulses part from the JAX package's by more than 1e-4
    # while positions stay within 1e-6, so its horizon is 25 steps
    "stack_warm": (_stack, None, 25, 5,
                   lambda s, sim: np.abs(np.asarray(s.warm_n)).max() > 0),
    "platform_lift": (_platform_scene((0, 0, 1), "sphere"), _lift, 90, 30,
                      lambda s, sim: (np.asarray(s.root_pos)[:, 1, 2] > 0.8).all()),
    "box_dragged": (_platform_scene((1, 0, 0), "box"), _drag, 90, 30,
                    lambda s, sim: (np.asarray(s.root_pos)[:, 1, 0] > 0.1).all()),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_stepped_scene_matches_jax(name):
    build, setup, steps, every, check = SCENES[name]
    jsim, sim = _sim(JAX, build), _sim(PORT, build)
    assert sim.stepper.contact.num_contacts == jsim.stepper.contact.num_contacts > 0
    assert (sim.state.warm_n is None) == (jsim.state.warm_n is None)
    if setup is not None:
        setup(jsim, sim)
    step = jax.jit(jsim.stepper.step)
    js = jsim.state
    with rolled_scan():
        for k in range(steps):
            js = step(js, jsim.actions, jsim.params)
            sim.step()
            if (k + 1) % every == 0:
                got, want = to_numpy(sim.state), _numpy(js)
                for f in FIELDS:
                    if want[f] is not None and want[f].size:
                        close(got[f], want[f], f"{name} {f} after {k + 1} steps", tol=STEP_TOL)
    assert check(js, jsim), f"{name}: the JAX run did not do what the scene is for"
    assert np.abs(np.asarray(js.contact_force)).max() > 0

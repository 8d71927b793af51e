"""Port parity: the neighbor-list contact path of large mixed box/sphere
worlds (ops/neighbor_world.py, physics/contacts.py) against the JAX package.

The worlds of tests/test_neighbor_world.py, built alike by both packages:
80 boxes in one collision group, the 128-box two-layer aligned stack, 100
spheres beside 100 boxes (the sphere-world path takes the sphere pairs),
and 140 bodies whose shapes sit off their body origin, the boxes rotated.
  * the spec and the static table: the same bodies take the path, and
    nothing is left for the table where the JAX package leaves nothing;
  * `solve` on the same inputs, made from a JAX state of each world in
    contact (two envs: that state, and it with its velocities halved),
    tolerance 1e-5 * max(|ref|, 1). On the aligned stack the
    manifold's corner depths tie exactly (clamped to the SAT overlap) and
    up to the last bits (face on face), which is where the order of the
    top-k and the rounding of the dot products decide which corners are
    kept;
  * stepped worlds, 30 steps, the goldens' rule 1e-4 * max(|ref|, 1).
  * the side-b segment sum against `scatter_add_` (1e-6), and, on the
    card (`-m cuda`), two solves of a 1080-box world bitwise equal.
    The aligned stack is not stepped against the JAX package: there the
    choice among near-tied corners turns on the last bit, and the JAX
    package's own jitted and op-by-op steps part after 7 steps (1.55 rad/s
    in angular velocity). It is held instead to the JAX test's bounds.
The 1080-box world runs on the card (chip_smoke.py); its CPU step takes
seconds.
"""
import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import test_isaacgym_tpu.ops.neighbor_world as jnw
import test_isaacgym_tpu_torch.ops.neighbor_world as tnw
from test_isaacgym_tpu_torch.core.state import to_numpy
from test_torch_contacts import rolled_scan
from test_torch_kinematics import JAX, PORT, close

TOL, ATOL = 1e-5, 1e-4
FIELDS = ("root_pos", "root_quat", "root_linvel", "root_angvel", "contact_force")


def _mods(pkg):
    return [importlib.import_module(f"{pkg}.{m}")
            for m in ("core.config", "core.scene", "core.sim", "assets.primitives")]


def _sim(pkg, b, simm, device="cpu"):
    if pkg == JAX:
        return simm.Simulator(*b.finalize())
    return simm.Simulator(*b.finalize(device), device=device)


def box_world(pkg, n_boxes, layers=1, spacing=0.25, h=0.1, seed=3, device="cpu"):
    """tests/test_neighbor_world.py::_box_world."""
    cfg, sc, simm, prim = _mods(pkg)
    sp = cfg.SimParams(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, -9.8))
    sp.physx.num_position_iterations = 4
    box = prim.create_box(2 * h, 2 * h, 2 * h, density=500.0)
    b = sc.SceneBuilder(sp)
    b.add_ground(cfg.PlaneParams())
    b.create_env((-50, -50, 0), (50, 50, 10), 1)
    rng = np.random.RandomState(seed)
    side = int(np.ceil(np.sqrt(n_boxes / layers)))
    i = 0
    for lz in range(layers):
        for gy in range(side):
            for gx in range(side):
                if i >= n_boxes:
                    break
                jitter = rng.uniform(-0.01, 0.01, 2)
                b.create_actor(
                    0, box,
                    pos=(gx * spacing + jitter[0], gy * spacing + jitter[1],
                         h + 0.002 + lz * (2 * h + 0.05)),
                    name=f"box{i}", group=-1, filter=0,
                )
                i += 1
    return _sim(pkg, b, simm, device)


def mixed_world(pkg):
    """tests/test_neighbor_world.py::test_mixed_spheres_and_boxes."""
    cfg, sc, simm, prim = _mods(pkg)
    sp = cfg.SimParams(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, -9.8))
    box = prim.create_box(0.2, 0.2, 0.2, density=500.0)
    ball = prim.create_sphere(0.1, density=500.0)
    b = sc.SceneBuilder(sp)
    b.add_ground(cfg.PlaneParams())
    b.create_env((-50, -50, 0), (50, 50, 10), 1)
    rng = np.random.RandomState(0)
    for i in range(200):
        gx, gy = divmod(i, 15)
        b.create_actor(0, box if i % 2 else ball,
                       pos=(gx * 0.35, gy * 0.35, 0.12 + rng.uniform(0, 0.3)),
                       name=f"o{i}", group=-1, filter=0)
    return _sim(pkg, b, simm)


def offset_world(pkg):
    """tests/test_neighbor_world.py::test_offset_rotated_shapes_take_fast_path."""
    cfg, sc, simm, prim = _mods(pkg)
    t = importlib.import_module(f"{pkg}.assets.types")
    sp = cfg.SimParams(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, -9.8))
    box = prim.create_box(0.2, 0.2, 0.2, density=500.0)
    ball = prim.create_sphere(0.1, density=500.0)
    for a, off in ((box, (0.05, 0.02, 0.03)), (ball, (0.0, 0.04, -0.02))):
        g = a.links[0].geoms[0]
        g.pos = off
        if g.kind == t.GEOM_BOX:
            s2 = float(np.sin(0.3 / 2))
            g.quat = (0.0, 0.0, s2, float(np.cos(0.3 / 2)))
    b = sc.SceneBuilder(sp)
    b.add_ground(cfg.PlaneParams())
    b.create_env((-50, -50, 0), (50, 50, 10), 1)
    rng = np.random.RandomState(3)
    for i in range(140):
        gx, gy = divmod(i, 12)
        b.create_actor(0, box if i % 2 else ball,
                       pos=(gx * 0.4, gy * 0.4, 0.2 + rng.uniform(0, 0.3)),
                       name=f"o{i}", group=-1, filter=0)
    return _sim(pkg, b, simm)


WORLDS = {
    "boxes80": functools.partial(box_world, n_boxes=80),
    "stack128": functools.partial(box_world, n_boxes=128, layers=2, spacing=0.5),
    "mixed200": mixed_world,
    "offset140": offset_world,
}
# JAX steps before the captured solve: each world in contact (the stack's
# top layer rests on the bottom one from step 8)
CAPTURE_AT = {"boxes80": 20, "stack128": 40, "mixed200": 30, "offset140": 30}


@functools.lru_cache(maxsize=None)
def _jax_sim(world):
    sim = WORLDS[world](JAX)
    with rolled_scan():
        sim.step_fn = jax.jit(sim.stepper.step)
    return sim


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_spec_and_static_table_match_jax(world):
    js, ts = _jax_sim(world), WORLDS[world](PORT)
    jc, tc = js.stepper.contact, ts.stepper.contact
    assert tc.neighbor_world is not None
    for f, want in jc.neighbor_world._asdict().items():
        got = getattr(tc.neighbor_world, f)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want, f)
        else:
            assert got == want, f
    assert (tc.sphere_world is None) == (jc.sphere_world is None)
    assert tc.num_contacts == jc.num_contacts
    if world != "offset140":
        assert tc.num_contacts == 0  # nothing left for the static table


def _solve_args(world):
    """The arguments of the JAX package's neighbor-world solve, as its
    ContactSolver makes them, from the state after CAPTURE_AT[world]
    jitted steps (post-step velocities in place of the pre-contact ones)."""
    from test_isaacgym_tpu.math.quat import quat_mul, quat_rotate, quat_to_matrix
    from test_isaacgym_tpu.utils.linalg import spd_inv

    js = _jax_sim(world)
    s = js.state
    with rolled_scan():
        for _ in range(CAPTURE_AT[world]):
            s = js.step_fn(s, js.actions, js.params)
    spec, p = js.stepper.contact.neighbor_world, js.params
    px = js.scene.sim_params.physx
    fidx, sidx, bidx = spec.free_idx, spec.shape_idx, spec.body_slot
    free = js.scene.free_group
    R = np.asarray(quat_to_matrix(s.body_quat[:, bidx]))
    inertia = np.asarray(p.body_inertia)[:, free.body_slot[fidx]]
    I_w = R @ inertia @ np.swapaxes(R, -1, -2)
    arm = quat_rotate(s.body_quat[:, bidx], p.shape_pos[:, sidx])
    w0 = np.asarray(s.root_angvel)[:, free.slots[fidx]]
    args = (
        s.body_pos[:, bidx] + arm,
        quat_mul(s.body_quat[:, bidx], spec.local_quat[None]),
        np.asarray(s.root_linvel)[:, free.slots[fidx]] + np.cross(w0, np.asarray(arm)),
        w0,
        p.shape_size[:, sidx],
        1.0 / np.asarray(p.body_mass)[:, free.body_slot[fidx]],
        spd_inv(I_w),
        p.shape_friction[:, sidx],
        p.shape_restitution[:, sidx],
    )
    consts = (js.stepper.h,
              max(6, 2 * px.num_position_iterations) + px.num_velocity_iterations,
              px.contact_offset, px.rest_offset + px.contact_slop,
              px.bounce_threshold_velocity)
    return spec, [np.array(a, np.float32) for a in args], consts


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_solve_matches_jax(world):
    spec, args, consts = _solve_args(world)
    # a second env: the same world with its velocities halved
    args = [np.concatenate([a, a * (0.5 if k in (2, 3) else 1.0)]) for k, a in enumerate(args)]
    with rolled_scan():
        want = jax.jit(lambda *a: jnw.solve(spec, *a, *consts))(*args)
    got = tnw.solve(spec, *[torch.as_tensor(a) for a in args], *consts)
    for name, g, w in zip(("vel", "omega", "cf"), got, want):
        close(g.numpy(), np.asarray(w), f"{world} solve {name}", tol=TOL)
    assert np.abs(np.asarray(want[2])).max() > 1.0  # the world is in contact


@pytest.mark.parametrize("world", ["boxes80", "mixed200", "offset140"])
def test_steps_like_jax(world):
    js, ts = _jax_sim(world), WORLDS[world](PORT)
    a, s = js.state, ts.state
    with rolled_scan():
        for k in range(1, 31):
            a = js.step_fn(a, js.actions, js.params)
            s = ts.stepper.step(s, ts.actions, ts.params)
            if k % 10 == 0:
                got = to_numpy(s)
                for f in FIELDS:
                    close(got[f], np.asarray(getattr(a, f)), f"{world} {f} after {k} steps",
                          tol=ATOL)


def test_aligned_stack_stays_stacked():
    """The JAX test's bounds on the port: most of the 64 top boxes still
    stacked after 150 steps, and the pile at rest."""
    sim = WORLDS["stack128"](PORT)
    s = sim.stepper.rollout(sim.state, sim.actions, sim.params, 150)
    z = s.root_pos[0, :, 2]
    assert int((z > 0.25).sum()) >= 40
    assert float(s.root_linvel.abs().max()) < 0.15


def test_segment_sum_matches_scatter_add():
    """The solve's per-body side-b sums (`_Segments`: a stable sort by body
    once, then float64 cumulative sums differenced at the segment ends) give
    the scatter-add's sums, on rows whose indices miss some bodies and hit
    others many times."""
    rng = np.random.RandomState(4)
    N, R, F = 3, 2000, 90
    idx = torch.as_tensor(rng.randint(0, F - 7, (N, R)))  # bodies F-7.. get no row
    rows = torch.as_tensor(rng.normal(size=(N, R, 2, 3)).astype(np.float32))
    got = tnw._Segments(idx, F)(rows)
    flat = rows.reshape(N, R, 6)
    want = flat.new_zeros((N, F, 6)).scatter_add_(1, idx[..., None].expand(-1, -1, 6), flat)
    assert got.shape == (N, F, 2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.reshape(N, F, 6).numpy(), want.numpy(), rtol=0, atol=1e-6 *
                               max(float(want.abs().max()), 1.0))
    assert float(got[:, F - 7:].abs().max()) == 0.0


@pytest.mark.cuda
def test_solve_bitwise_repeatable_on_cuda():
    """Two neighbor-world solves of a 1080-box world in contact, on the
    card, give the same bits (no atomics in the per-body sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim = box_world(PORT, 1080, device="cuda")
    s = sim.stepper.rollout(sim.state, sim.actions, sim.params, 20)
    caught, solve = [], tnw.solve
    tnw.solve = lambda *a, **kw: caught.append((a, kw)) or solve(*a, **kw)
    try:
        sim.stepper.step(s, sim.actions, sim.params)
    finally:
        tnw.solve = solve
    args, kw = caught[0]
    first, second = solve(*args, **kw), solve(*args, **kw)
    assert float(first[2].abs().max()) > 1.0  # in contact
    assert all(torch.equal(a, b) for a, b in zip(first, second))

"""Port parity: terrain generation and heightfield contact against the JAX
package.

  * the 8 generators of terrain_utils and the trimesh conversion (with and
    without the wall-steepening slope threshold) give the same arrays as
    the JAX package's under the same `np.random.seed`;
  * `SceneBuilder.add_trimesh_as_heightfield` rasterises a regular grid
    (the terrain_utils trimesh) and an irregular mesh to the same
    heightfield as the JAX builder's;
  * `_heightfield_sdf` on seeded points inside the grid, beyond each of its
    edges and on them, tolerance 1e-5 of the largest magnitude;
  * stepped scenes at the goldens' rule 1e-4 * max(|ref|, 1): spheres,
    boxes, capsules and convex hulls dropped on a small rough terrain (60
    steps), the bowl of tests/test_gymapi.py::test_terrain_heightfield_contact
    (300 steps, and its bounds), and 120 balls (envs/balls.py's layout)
    over a bowl, where the sphere world runs without a ground and each
    ball's terrain contact is a row of the contact table (60 steps);
  * the terrain path's golden (terrain_pile.npz: envs/pile.py's objects
    over the AnymalTerrain map, 8 envs spread over its levels and terrain
    types, made by the JAX package) reproduced by the port's own build.

Run as a script, this regenerates that golden, every 10th step up to the
JAX package's self-agreement horizon (its jitted and op-by-op steps within
the goldens' rule), and stores beside it the terrain clearances
(envs/pile.py::terrain_clearance) of the JAX package's 4096 envs after 120
steps, which chip_smoke.py prints beside the card's:
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_terrain.py
"""
import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_isaacgym_tpu import terrain_utils as jtu  # noqa: E402
from test_isaacgym_tpu.physics.contacts import _heightfield_sdf as jax_hf_sdf  # noqa: E402
from test_isaacgym_tpu_torch import terrain_utils as ttu  # noqa: E402
from test_isaacgym_tpu_torch.core.state import to_numpy  # noqa: E402
from test_isaacgym_tpu_torch.physics.contacts import _heightfield_sdf as hf_sdf  # noqa: E402
from test_torch_contacts import close_rel, rolled_scan  # noqa: E402
from test_isaacgym_tpu_torch.envs import pile  # noqa: E402
from test_torch_hull import (  # noqa: E402
    BIG_ENVS, BIG_STEPS, GOLDEN_EVERY, check_golden_on_port, golden_run, jax_sphere_hull_shim,
    pile_sim, self_agreement)
from test_torch_kinematics import JAX, PORT, close  # noqa: E402

torch.set_num_threads(1)

STEP_TOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(pile.__file__), "..", "assets", "data", "terrain_pile.npz")
# 8 envs of the 4096-env grid, one on each of 8 (level, terrain type) tiles:
# (0, slope down), (2, rough down), (5, stairs down), (8, stairs down), (1,
# stairs up), (4, stairs up), (6, obstacles), (9, obstacles)
GOLDEN_IDS = (0, 585, 1170, 1755, 2340, 2925, 3510, 4095)
FIELDS = ("root_pos", "root_quat", "root_linvel", "root_angvel", "contact_force")

# name: (generator, arguments); test_gymapi.py::test_terrain_generators_shapes
GENERATORS = {
    "random_uniform": ("random_uniform_terrain", (-0.2, 0.2, 0.2, 0.5)),
    "sloped": ("sloped_terrain", (-0.5,)),
    "pyramid_sloped": ("pyramid_sloped_terrain", (-0.5,)),
    "discrete_obstacles": ("discrete_obstacles_terrain", (0.5, 1.0, 2.0, 20)),
    "wave": ("wave_terrain", (2.0, 1.0)),
    "stairs": ("stairs_terrain", (0.75, -0.5)),
    "pyramid_stairs": ("pyramid_stairs_terrain", (0.75, -0.5)),
    "stepping_stones": ("stepping_stones_terrain", (1.0, 1.0, 0.5, 0.0)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_jax(name):
    fn, args = GENERATORS[name]
    out = []
    for tu in (ttu, jtu):
        np.random.seed(3)
        sub = tu.SubTerrain(width=40, length=36, vertical_scale=0.005, horizontal_scale=0.1)
        out.append(getattr(tu, fn)(sub, *args).height_field_raw)
    assert out[0].dtype == out[1].dtype == np.int16
    np.testing.assert_array_equal(out[0], out[1])
    assert out[0].any()


@pytest.mark.parametrize("slope_threshold", [None, 1.5])
def test_trimesh_matches_jax(slope_threshold):
    np.random.seed(5)
    sub = ttu.SubTerrain(width=24, length=20, vertical_scale=0.005, horizontal_scale=0.25)
    raw = ttu.discrete_obstacles_terrain(sub, 0.3, 0.5, 1.5, 12).height_field_raw
    got = ttu.convert_heightfield_to_trimesh(raw, 0.25, 0.005, slope_threshold)
    want = jtu.convert_heightfield_to_trimesh(raw, 0.25, 0.005, slope_threshold)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _mods(pkg):
    return [importlib.import_module(f"{pkg}.{m}")
            for m in ("assets.primitives", "core.config", "core.scene", "core.sim")]


def _bowl(width=32, hscale=0.25):
    """test_terrain_heightfield_contact's bowl: an inverted pyramid."""
    sub = ttu.SubTerrain(width=width, length=width, vertical_scale=0.005, horizontal_scale=hscale)
    return ttu.pyramid_sloped_terrain(sub, slope=-0.5).height_field_raw


@pytest.mark.parametrize("mesh", ["grid", "irregular"])
def test_trimesh_rasterises_like_jax(mesh):
    """add_trimesh_as_heightfield: a terrain_utils trimesh is a regular grid
    and comes back exactly; an irregular point set is binned by max z."""
    if mesh == "grid":
        verts, tris = ttu.convert_heightfield_to_trimesh(_bowl(), 0.25, 0.005, 1.5)
    else:
        rng = np.random.RandomState(2)
        verts = rng.uniform(0, 3, (400, 3)).astype(np.float32)
        tris = rng.randint(0, 400, (100, 3)).astype(np.uint32)
    fields = []
    for pkg in (PORT, JAX):
        _, cfg, sc, _ = _mods(pkg)
        b = sc.SceneBuilder(cfg.SimParams())
        b.add_trimesh_as_heightfield(verts, tris, offset_x=1.5, offset_y=-2.0)
        hf = b.heightfield
        fields.append((hf.data, hf.horizontal_scale, hf.offset_x, hf.offset_y))
    np.testing.assert_array_equal(fields[0][0], fields[1][0])
    assert fields[0][1:] == fields[1][1:]
    if mesh == "grid":
        np.testing.assert_array_equal(fields[0][0], _bowl() * np.float32(0.005))


@pytest.mark.parametrize("where", ["inside", "outside", "edge"])
def test_heightfield_sdf_matches_jax(where):
    rng = np.random.RandomState(7)
    R, C, hs, off = 32, 24, 0.1, (-1.0, 0.5)
    data = rng.uniform(-0.3, 0.3, (R, C)).astype(np.float32)
    n = 400
    x = rng.uniform(0, (R - 1) * hs, n)
    y = rng.uniform(0, (C - 1) * hs, n)
    if where == "outside":  # a quarter beyond each edge
        q = n // 4
        x[:q] = -rng.uniform(0.01, 1.0, q)
        x[q:2 * q] = (R - 1) * hs + rng.uniform(0.01, 1.0, q)
        y[2 * q:3 * q] = -rng.uniform(0.01, 1.0, q)
        y[3 * q:] = (C - 1) * hs + rng.uniform(0.01, 1.0, q)
    elif where == "edge":  # on the grid's border lines and its corners
        x[: n // 2] = rng.choice([0.0, (R - 1) * hs], n // 2)
        y[n // 2:] = rng.choice([0.0, (C - 1) * hs], n - n // 2)
    p = np.stack([x + off[0], y + off[1], rng.uniform(-0.5, 0.5, n)], -1).astype(np.float32)
    p = p.reshape(4, n // 4, 3)
    want = jax_hf_sdf(jax.numpy.asarray(data), hs, off, jax.numpy.asarray(p))
    corner = torch.tensor([0, C, 1, C + 1])
    got = hf_sdf(torch.as_tensor(data), hs, off, torch.as_tensor(p), corner)
    for name, g, w in zip(("distance", "normal"), got, want):
        close_rel(g.numpy(), np.asarray(w), f"{where} {name}")
    if where == "outside":  # flat beyond the grid along the axis that left it
        n_ = got[1].numpy().reshape(n, 3)
        assert np.abs(n_[: n // 2, 0]).max() == 0 and np.abs(n_[n // 2:, 1]).max() == 0


def _sim(pkg, build):
    _, cfg, sc, sm = _mods(pkg)
    b = build(pkg)
    if pkg == JAX:
        return sm.Simulator(*b.finalize())
    return sm.Simulator(*b.finalize("cpu"), device="cpu")


def _objects_on_rough(pkg):
    """Spheres, boxes, capsules and two convex hulls (a box-like hull and a
    seeded irregular one) dropped in 2 envs onto a small rough slope."""
    prim, cfg, sc, _ = _mods(pkg)
    np.random.seed(21)
    sub = ttu.SubTerrain(width=48, length=48, vertical_scale=0.005, horizontal_scale=0.1)
    ttu.pyramid_sloped_terrain(sub, slope=0.2)
    raw = ttu.random_uniform_terrain(sub, -0.05, 0.05, 0.01, 0.3).height_field_raw
    b = sc.SceneBuilder(cfg.SimParams(dt=1 / 60, substeps=2))
    b.add_heightfield(raw, 0.1, 0.005, -2.4, -2.4)
    cube = np.array([[x, y, z] for x in (-0.06, 0.06) for y in (-0.04, 0.04) for z in (-0.05, 0.05)],
                    np.float32)
    rock = np.random.RandomState(4).normal(size=(30, 3)).astype(np.float32) * [0.06, 0.05, 0.04]
    faces = np.zeros((0, 3), np.int32)
    objs = [prim.create_sphere(0.08), prim.create_box(0.15, 0.1, 0.12),
            prim.create_capsule(0.05, 0.08), prim.create_mesh_asset("cube", cube, faces),
            prim.create_mesh_asset("rock", rock, faces)]
    rng = np.random.RandomState(5)
    for e in range(2):
        b.create_env((-1.2, -1.2, 0), (1.2, 1.2, 1), 2)
        for k, a in enumerate(objs):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            b.create_actor(e, a, pos=(0.4 * k - 0.8, rng.uniform(-0.5, 0.5), 0.6), quat=tuple(q),
                           name=f"o{k}", group=e, filter=0)
    return b


def _bowl_ball(pkg):
    """tests/test_gymapi.py::test_terrain_heightfield_contact, on the
    builder: the bowl's trimesh rasterised back, a ball of r 0.2 dropped
    at (3, 4, 3), the default SimParams."""
    prim, cfg, sc, _ = _mods(pkg)
    np.random.seed(17)
    verts, tris = ttu.convert_heightfield_to_trimesh(_bowl(), 0.25, 0.005, slope_threshold=1.5)
    b = sc.SceneBuilder(cfg.SimParams())
    b.add_trimesh_as_heightfield(verts, tris)
    b.create_env((0, 0, 0), (8, 8, 4), 1)
    b.create_actor(0, prim.create_sphere(0.2), pos=(3.0, 4.0, 3.0), name="ball", group=0, filter=0)
    return b


BALLS_STEPS = 240  # chip_smoke.py's balls_terrain1080


def _balls_over_bowl(pkg, pyramids=36):
    """envs/balls.py's world of `pyramids` pyramids of 30 balls (r 0.2 m,
    seed 17) over a 64 x 64 bowl at 0.25 m, offset (-8, -8): the sphere
    world, with no ground of its own, beside the table's sphere-terrain
    rows. At 36 pyramids, chip_smoke.py's balls_terrain1080."""
    prim, cfg, sc, _ = _mods(pkg)
    sp = cfg.SimParams(dt=1 / 60, substeps=1, gravity=(0.0, 0.0, -9.8))
    sp.physx.num_position_iterations = 4
    sp.physx.num_velocity_iterations = 1
    b = sc.SceneBuilder(sp)
    b.add_heightfield(_bowl(64), 0.25, 0.005, -8.0, -8.0)
    b.create_env((-8, -8, 0), (8, 8, 8), 1)
    ball = prim.create_sphere(0.2, density=500.0)
    jitter = np.random.RandomState(17).uniform(-0.01, 0.01, (pyramids, 2))
    grid = int(np.ceil(np.sqrt(pyramids)))
    k = 0
    for p in range(pyramids):
        cx = (p % grid - (grid - 1) / 2) * 2.5 + jitter[p, 0]
        cy = (p // grid - (grid - 1) / 2) * 2.5 + jitter[p, 1]
        n, z = 4, 1.5
        while n > 0:
            m = -0.5 * (n - 1) * 0.5
            for i in range(n):
                for j in range(n):
                    b.create_actor(0, ball, pos=(cx + m + i * 0.5, cy + m + j * 0.5, z),
                                   name=f"ball{k}", group=0, filter=0)
                    k += 1
            z += 0.5
            n -= 1
    return b


SCENES = {"objects_on_rough": (_objects_on_rough, 60, 20),
          "bowl_ball": (_bowl_ball, 300, 50),
          "balls_in_bowl": (lambda pkg: _balls_over_bowl(pkg, pyramids=4), 60, 20)}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_stepped_on_terrain_matches_jax(name):
    build, steps, every = SCENES[name]
    jsim, sim = _sim(JAX, build), _sim(PORT, build)
    c = sim.stepper.contact
    assert c.num_contacts == jsim.stepper.contact.num_contacts > 0
    assert sim.scene.heightfield is not None
    if name == "balls_in_bowl":
        assert c.sphere_world is not None and not c.sphere_world.has_ground
        assert c.num_contacts == 120  # one terrain row a ball
    with jax_sphere_hull_shim(), rolled_scan():
        step = jax.jit(jsim.stepper.step)
        js, s = jsim.state, sim.state
        for k in range(1, steps + 1):
            js = step(js, jsim.actions, jsim.params)
            s = sim.stepper.step(s, sim.actions, sim.params)
            if k % every == 0:
                got = to_numpy(s)
                for f in FIELDS:
                    close(got[f], np.asarray(getattr(js, f)), f"{name} {f} after {k} steps",
                          tol=STEP_TOL)
    # the bounds of test_terrain_heightfield_contact on the port's end state
    # (a pile of balls stacks higher than one ball rests)
    hf = sim.scene.heightfield
    pos = to_numpy(s)["root_pos"][0]
    i = np.clip(np.rint((pos[:, 0] - hf.offset_x) / hf.horizontal_scale).astype(int), 0,
                hf.data.shape[0] - 1)
    j = np.clip(np.rint((pos[:, 1] - hf.offset_y) / hf.horizontal_scale).astype(int), 0,
                hf.data.shape[1] - 1)
    ground = hf.data[i, j]
    assert (pos[:, 2] > ground - 0.05).all(), name
    if name != "balls_in_bowl":
        assert (pos[:, 2] < ground + 0.45).all(), name


def test_terrain_golden_reproduced_by_port():
    """The terrain golden, its 8 envs over the full 1200 x 2000 map."""
    sim = check_golden_on_port(GOLDEN, terrain=pile.anymal_terrain())
    assert sim.scene.heightfield.data.shape == (1200, 2000)


def main():
    terrain = pile.anymal_terrain()
    with jax_sphere_hull_shim(), rolled_scan():
        jsim = pile_sim(JAX, GOLDEN_IDS, terrain=terrain)
        agree = self_agreement(jsim, 120)
        steps = agree // GOLDEN_EVERY * GOLDEN_EVERY
        print(f"terrain {len(GOLDEN_IDS)} envs: jitted and op-by-op JAX steps agree for {agree} "
              f"steps; golden every {GOLDEN_EVERY} steps to step {steps}", flush=True)
        golden, _ = golden_run(jsim, steps, GOLDEN_EVERY)
        big = pile_sim(JAX, range(BIG_ENVS), terrain=terrain)
        _, end = golden_run(big, BIG_STEPS, BIG_STEPS)
        balls = _sim(JAX, _balls_over_bowl)
        _, bend = golden_run(balls, BALLS_STEPS, BALLS_STEPS)
    hf = big.scene.heightfield
    below, above = pile.terrain_clearance(hf.data, hf.horizontal_scale, hf.offset_x,
                                          np.asarray(end.root_pos))
    print(f"terrain JAX {BIG_ENVS} envs after {BIG_STEPS} steps: lowest centre {below:.6f} m "
          f"above the lowest terrain within 0.1 m, highest {above:.6f} m above the highest")
    depth = float(np.asarray(balls.stepper.contact.narrowphase(
        bend.body_pos, bend.body_quat, balls.params)[2]).max())
    ball_low = pile.terrain_clearance(balls.scene.heightfield.data, 0.25, -8.0,
                                      np.asarray(bend.root_pos), reach=0.0)[0]
    print(f"balls_terrain JAX 1080 balls after {BALLS_STEPS} steps: lowest centre {ball_low:.6f} "
          f"m above the terrain, deepest contact {depth:.6f} m")
    np.savez_compressed(os.path.abspath(GOLDEN), **golden, env_ids=np.asarray(GOLDEN_IDS),
                        self_agree=agree, jax_below=below, jax_above=above,
                        jax_balls_lowest=ball_low, jax_balls_depth=depth)
    print(f"wrote {os.path.abspath(GOLDEN)}")


if __name__ == "__main__":
    main()

"""Soft-body scenes: tet icospheres on the XPBD solve (physics/soft.py).

  * soft_body: the reference's examples/soft_body.py. Y-up, gravity -9.8 y,
    dt 1/60, 3 substeps, FleX budget 4 x 20 iterations at relaxation 0.8,
    one icosphere actor an env (thickness 0.1) at y = 2.0 in a (-3, 0, -3)
    .. (3, 3, 3) env grid of int(sqrt(N)) a row over a ground plane of
    normal +y, its press rail PD-held at 0 (stiffness 1e7, damping 1e5,
    effort 1e6: the rail has no `<limit effort>`), and each env's Young's,
    Poisson and damping drawn as the example draws them (random.seed(7),
    uniform in [0.2 E, 2.4 E], [0.8 nu, 1.2 nu] and [0, 0.08]^2 in env
    order), Poisson's ratio then clipped to POISSON_MAX: the example's
    range reaches 0.54, past the isotropic limit 0.5, where lambda < 0 and
    the solve blows up in both packages (230 of the first 1024 draws; the
    example's own 4 envs stay below 0.5). `drop_fields(..., materials=False)`
    with a drop height and a rail speed limit gives tests/test_soft.py's
    `_make_sim` scene instead.
  * pedestals: tests/test_soft.py::test_soft_settles_on_sphere_capsule_hull.
    Z-up; three icospheres (thickness 0.05) over a fixed sphere (r 0.5), a
    cradle of two horizontal capsules (r 0.3, half length 0.4) and a convex
    frustum pedestal. With soft_body's press plate (a box), the two scenes
    reach every collider kind of the soft solve.

The icosphere is the code-built stand-in committed in this package
(assets/data/icosphere_standin, written by tools/make_icosphere_standin.py):
the reference's icosphere.urdf and .tet are not in the repository.

The builders take a package's modules as arguments (`config`, a
SceneBuilder, `prim`: an assets.primitives module), so one definition
builds the same scene in this package and, in the tests, in the JAX one;
`drop_fields` gives the PhysParams fields both set, as numpy arrays.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch

from .. import assets
from ..core import config as _config
from ..core.scene import SceneBuilder
from ..core.sim import Simulator

STANDIN_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "data", "icosphere_standin",
)
ICOSPHERE_URDF = "urdf/icosphere.urdf"
SOFT_THICKNESS, PEDESTAL_THICKNESS = 0.1, 0.05
DROP_HEIGHT = 2.0  # the example's actor pose
MATERIAL_SEED = 7  # the example's random.seed(7)
POISSON_MAX = 0.499  # just under the isotropic limit of 0.5
PRESS_STIFFNESS, PRESS_DAMPING, PRESS_EFFORT = 1.0e7, 1.0e5, 1.0e6


def soft_params(config, up_y=True):
    """examples/soft_body.py's SimParams (Y-up), or the pedestal test's
    (Z-up, its default relaxation)."""
    if not up_y:
        sp = config.SimParams(dt=1 / 60, substeps=3, gravity=(0.0, 0.0, -9.8))
    else:
        sp = config.SimParams(dt=1 / 60, substeps=3, gravity=(0.0, -9.8, 0.0))
        sp.up_axis = config.UP_AXIS_Y
        sp.flex.relaxation = 0.8
    sp.flex.num_outer_iterations = 4
    sp.flex.num_inner_iterations = 20
    return sp


def icosphere(urdf_loader, thickness, root=STANDIN_ROOT):
    """The icosphere asset (fixed base) loaded by a package's load_urdf."""
    a = urdf_loader(root, ICOSPHERE_URDF, fix_base_link=True)
    a.thickness = thickness
    return a


def build_drop(builder, config, asset, num_envs, height=DROP_HEIGHT):
    """Fill `builder` with the soft_body scene's ground and envs."""
    pp = config.PlaneParams()
    pp.normal = (0, 1, 0)
    builder.add_ground(pp)
    per_row = int(np.sqrt(num_envs)) or 1
    for e in range(num_envs):
        builder.create_env((-3, 0, -3), (3, 3, 3), per_row)
        builder.create_actor(e, asset, pos=(0, height, 0), name="soft", group=e, filter=1)
    return builder


def example_materials(num_envs, youngs, poissons, seed=MATERIAL_SEED):
    """(youngs, poissons, damping) float32 (N,) drawn as the example draws
    them around the asset's (youngs, poissons), Poisson's ratio clipped to
    POISSON_MAX."""
    rng = random.Random(seed)
    out = []
    for _ in range(num_envs):
        e = rng.uniform(youngs * 0.2, youngs * 2.4)
        nu = min(rng.uniform(poissons * 0.8, poissons * 1.2), POISSON_MAX)
        out.append((e, nu, rng.uniform(0.0, 0.08) ** 2))
    return tuple(np.asarray(col, np.float32) for col in zip(*out))


def drop_fields(scene, materials=True, youngs=None, max_velocity=None):
    """PhysParams fields (numpy) of the soft_body scene: the press rail held
    at its target by the PD drive, each env's materials drawn as the
    example's (`materials`) or Young's set to `youngs` (N,), and the rail's
    speed limit `max_velocity` if given (tests/test_soft.py's slow press)."""
    n, d = scene.num_envs, scene.num_dofs_per_env
    f = {
        "dof_stiffness": np.full((n, d), PRESS_STIFFNESS, np.float32),
        "dof_damping": np.full((n, d), PRESS_DAMPING, np.float32),
        "dof_drive_mode": np.ones((n, d), np.int32),
        "dof_max_effort": np.full((n, d), PRESS_EFFORT, np.float32),
    }
    if max_velocity is not None:
        f["dof_max_velocity"] = np.full((n, d), max_velocity, np.float32)
    inst = scene.soft.instances
    if materials:
        e, nu, damp = example_materials(n, inst[0].youngs, inst[0].poissons)
        f["soft_youngs"], f["soft_poissons"], f["soft_damping"] = (
            np.repeat(x[:, None], len(inst), 1) for x in (e, nu, damp))
    if youngs is not None:
        f["soft_youngs"] = np.repeat(np.asarray(youngs, np.float32)[:, None], len(inst), 1)
    return f


def frustum_mesh():
    """(vertices, faces) of the pedestal test's squat convex frustum: a 2 x 2
    m base, a flat 0.7-half-width top at z = 0.4."""
    fv = np.array(
        [[sx, sy, 0.0] for sx in (-1, 1) for sy in (-1, 1)]
        + [[0.7 * sx, 0.7 * sy, 0.4] for sx in (-1, 1) for sy in (-1, 1)],
        np.float32,
    )
    ff = np.array(
        [[0, 1, 2], [1, 3, 2], [4, 6, 5], [5, 6, 7],
         [0, 4, 1], [1, 4, 5], [1, 5, 3], [3, 5, 7],
         [3, 7, 2], [2, 7, 6], [2, 6, 0], [0, 6, 4]], np.int32
    )
    return fv, ff


def build_pedestals(builder, config, prim, asset):
    """Fill `builder` with the pedestal test's one env: a rigid sphere, two
    capsules and a frustum, each under a soft icosphere. The fem origin is
    (0, -0.5, 0) in the actor frame, so the actors stand at y = +0.5."""
    ball = prim.create_sphere(0.5, density=1000.0, fix_base_link=True)
    cap = prim.create_capsule(0.3, 0.8, density=1000.0, fix_base_link=True)
    frustum = prim.create_mesh_asset("frustum", *frustum_mesh(), density=1000.0,
                                     fix_base_link=True)
    yq = (0.0, 0.70710678, 0.0, 0.70710678)  # capsule axis z -> x
    builder.add_ground(config.PlaneParams())
    builder.create_env((-2, -2, 0), (8, 2, 4), 1)
    builder.create_actor(0, ball, pos=(0, 0, 0.5), name="ball", group=0, filter=1)
    builder.create_actor(0, cap, pos=(3.0, -0.35, 0.3), quat=yq, name="c1", group=0, filter=1)
    builder.create_actor(0, cap, pos=(3.0, 0.35, 0.3), quat=yq, name="c2", group=0, filter=1)
    builder.create_actor(0, frustum, pos=(6.0, 0, 0), name="frustum", group=0, filter=1)
    for x, z0 in ((0.0, 2.2), (3.0, 1.6), (6.0, 1.7)):
        builder.create_actor(0, asset, pos=(x, 0.5, z0), name=f"soft{x}", group=0, filter=1)
    return builder


def _set(sim, fields):
    p = sim.params
    sim.params = p._replace(**{k: torch.as_tensor(v, device=sim.device) for k, v in fields.items()})
    return sim


def soft_body_sim(num_envs, device="cuda", height=DROP_HEIGHT, materials=True, youngs=None,
                  max_velocity=None) -> Simulator:
    """A Simulator of the soft_body scene on `device`."""
    b = build_drop(SceneBuilder(soft_params(_config)), _config,
                   icosphere(assets.load_urdf, SOFT_THICKNESS), num_envs, height)
    sim = Simulator(*b.finalize(device), device=device)
    return _set(sim, drop_fields(sim.scene, materials, youngs, max_velocity))


def pedestals_sim(device="cuda") -> Simulator:
    """A Simulator of the pedestal scene on `device`."""
    from ..assets import primitives

    b = build_pedestals(SceneBuilder(soft_params(_config, up_y=False)), _config, primitives,
                        icosphere(assets.load_urdf, PEDESTAL_THICKNESS))
    return Simulator(*b.finalize(device), device=device)

"""Port parity: SDF grids and the K_PT_SDF narrowphase against the JAX
package.

  * `sdf_from_fn` grids of the procedural bolt (plain and with the tip
    chamfer) and of a box's closed form, and `sdf_from_mesh` grids of the
    committed nut stand-in and a code-built box: bitwise
    equal, with both packages' grid caches pointed at a temporary
    directory; the bolt meshes equal too;
  * the bolt's closed form on torch tensors against the JAX package's on
    jnp arrays, values and gradients (jax.grad against autograd) within
    1e-5, on probes spread around the thread and on probes placed exactly
    on the crest phase and the mid-root phase, where `clip` and `minimum`
    tie (a torch.clamp there would give a different gradient; the test
    shows it does);
  * the closed-form detection: the bolt's function is taken, a numpy-only
    box SDF is not;
  * on an "SDF zoo" of one env (the procedural bolt with its closed form,
    the nut stand-in with a voxel grid, a box with a numpy-only SDF, so a
    voxel grid too, and a tetrahedron with no SDF and 40 probes, padded
    with the far sentinel; both directions of
    every pair kept), 96 seeded pose sets with shape sizes jittered per
    env: `_sdf_trilinear` on the table's two stacked grids, with queries
    inside and outside them, and the narrowphase's K_PT_SDF rows (both
    families, the strided manifold selection), within 1e-5 of the largest
    magnitude of each output.
"""
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_isaacgym_tpu.assets.sdf as jsdf  # noqa: E402
import test_isaacgym_tpu_torch.assets.sdf as tsdf  # noqa: E402
from test_isaacgym_tpu_torch.core.state import PhysParams, from_numpy  # noqa: E402
from test_isaacgym_tpu_torch.envs.nut_bolt import NUT_STANDIN_ROOT, NUT_URDF  # noqa: E402
from test_torch_contacts import _batch_params, close_rel  # noqa: E402
from test_torch_kinematics import JAX, PORT  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
K_PT_SDF = 17
N_POSES = 96
SPEC = tsdf.BoltSpec(scale=5.0)
CHAMFERED = tsdf.BoltSpec(scale=5.0, tip_chamfer=1.5)


@pytest.fixture(scope="module", autouse=True)
def grid_caches(tmp_path_factory):
    """Both packages' SDF caches in a directory of this module's: the grid
    tests bake into it first, and the zoo reads their grids back."""
    d = tmp_path_factory.mktemp("sdf_cache")
    saved = jsdf._CACHE_DIR, tsdf._CACHE_DIR
    jsdf._CACHE_DIR, tsdf._CACHE_DIR = str(d / "jax"), str(d / "torch")
    yield
    jsdf._CACHE_DIR, tsdf._CACHE_DIR = saved


def box_sdf(p, h=0.1):
    """A box's exact SDF on numpy arrays (tests/test_nut_bolt.py's)."""
    q = np.abs(p) - h
    outside = np.linalg.norm(np.maximum(q, 0), axis=-1)
    inside = np.minimum(q.max(-1), 0.0)
    return outside + inside


def box_mesh(h=(0.1, 0.1, 0.1)):
    c = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float32) * np.asarray(h, np.float32)
    faces = np.array(
        [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return c, faces


def tetra_mesh():
    tv = np.array([[0, 0, -0.02], [0.02, 0, 0.02], [-0.02, 0.02, 0.02], [-0.02, -0.02, 0.02]],
                  np.float32)
    tf = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]], np.int32)
    return tv, tf


def nut_mesh():
    from test_isaacgym_tpu_torch.assets.mesh import load_mesh

    return load_mesh(os.path.join(NUT_STANDIN_ROOT, "urdf", "nut_bolt", "nut_m4_tight_SI_5x.obj"))


def bolt_bounds(spec):
    s = spec.scale
    half_z = (spec.length + spec.head_h) * s * 0.5
    hr = spec.head_r * s
    return (-hr, -hr, -half_z), (hr, hr, half_z)


FN_CASES = {
    "bolt": lambda m: (m.bolt_sdf_fn(SPEC), *bolt_bounds(SPEC)),
    "chamfered_bolt": lambda m: (m.bolt_sdf_fn(CHAMFERED), *bolt_bounds(CHAMFERED)),
    "box": lambda m: (box_sdf, (-0.1,) * 3, (0.1,) * 3),
}
MESH_CASES = {
    "nut": nut_mesh,
    "box": lambda: box_mesh((0.05, 0.03, 0.02)),
}


@pytest.mark.parametrize("case", FN_CASES)
def test_sdf_from_fn_bitwise(case):
    j = jsdf.sdf_from_fn(*FN_CASES[case](jsdf))
    t = tsdf.sdf_from_fn(*FN_CASES[case](tsdf))
    for f in ("data", "origin", "spacing"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert (t.analytic is None) == (j.analytic is None) == (case == "box")


@pytest.mark.parametrize("case", MESH_CASES)
def test_sdf_from_mesh_bitwise(case):
    verts, faces = MESH_CASES[case]()
    j = jsdf.sdf_from_mesh(verts, faces)
    t = tsdf.sdf_from_mesh(verts, faces)
    for f in ("data", "origin", "spacing"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert (t.data < 0).any() and (t.data > 0).any()
    again = tsdf.sdf_from_mesh(verts, faces)  # read back from the cache
    np.testing.assert_array_equal(again.data, t.data)


def test_cache_keys_differ(tmp_path, monkeypatch):
    """One shared directory: the two packages keep separate files."""
    monkeypatch.setattr(jsdf, "_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tsdf, "_CACHE_DIR", str(tmp_path))
    v, f = box_mesh()
    jsdf.sdf_from_mesh(v, f)
    tsdf.sdf_from_mesh(v, f)
    assert len(os.listdir(tmp_path)) == 2


@pytest.mark.parametrize("spec", [SPEC, CHAMFERED], ids=["plain", "chamfered"])
def test_bolt_mesh_matches_jax(spec):
    for a, b in zip(tsdf.bolt_mesh(spec), jsdf.bolt_mesh(spec)):
        np.testing.assert_array_equal(a, b)


def test_closed_form_detection():
    assert tsdf.takes_tensors(tsdf.bolt_sdf_fn(SPEC))
    assert not tsdf.takes_tensors(box_sdf)
    grid = tsdf.sdf_from_fn(box_sdf, (-0.1,) * 3, (0.1,) * 3)
    assert grid.analytic is None


def test_no_analytic_switch(monkeypatch):
    monkeypatch.setenv("TIG_NO_ANALYTIC_SDF", "1")
    assert tsdf.sdf_from_fn(*FN_CASES["bolt"](tsdf)).analytic is None


def _crest_points(spec):
    """Probes on the bolt's crest phase (u = 0: r_thread = major, the clip's
    upper bound) and on the mid-root phase (u = pitch / 2: the two sides of
    minimum(u, pitch - u) tie), at theta = 0 (y = 0, x > 0), in the
    AABB-centered frame, at radii inside and outside the thread."""
    s = spec.scale
    pitch = np.float32(spec.pitch * s)
    crest = np.float32(spec.crest_phase * s)
    zc = np.float32((spec.length * s - spec.head_h * s) * 0.5)
    out = []
    for k in range(2, 9):
        for phase in (np.float32(0.0), pitch / np.float32(2.0)):
            z = np.float32(crest + np.float32(k) * pitch + phase)
            for r in (0.8, 0.95, 1.02, 1.1):
                out.append([r * spec.major_r * s, 0.0, z - zc])
    return np.asarray(out, np.float32)


def _spread_points(spec, seed=3, n=512):
    rng = np.random.RandomState(seed)
    s = spec.scale
    th = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(0.5, 1.3, n) * spec.major_r * s
    lo, hi = bolt_bounds(spec)
    z = rng.uniform(lo[2], hi[2], n)
    return np.stack([r * np.cos(th), r * np.sin(th), z], -1).astype(np.float32)


@pytest.mark.parametrize("spec", [SPEC, CHAMFERED], ids=["plain", "chamfered"])
def test_bolt_closed_form_and_gradient(spec):
    pts = np.concatenate([_spread_points(spec), _crest_points(spec)]).reshape(8, 71, 3)
    jfn, tfn = jsdf.bolt_sdf_fn(spec), tsdf.bolt_sdf_fn(spec)
    jv = np.asarray(jfn(jnp.asarray(pts)))
    jg = np.asarray(jax.grad(lambda r: jfn(r).sum())(jnp.asarray(pts)))
    x = torch.as_tensor(pts).requires_grad_(True)
    tv = tfn(x)
    tg = torch.autograd.grad(tv.sum(), x)[0]
    close_rel(tv.detach().numpy(), jv, "bolt sdf")
    close_rel(tg.numpy(), jg, "bolt sdf gradient")
    np.testing.assert_allclose(jfn(pts.copy()), jv, rtol=0, atol=1e-6)  # numpy path


def test_crest_ties_need_minimum_maximum(monkeypatch):
    """The crest probes reach the clip's bound: with torch.clamp in its
    place the gradient there departs from jax.grad's."""
    pts = _crest_points(SPEC)
    jfn = jsdf.bolt_sdf_fn(SPEC)
    jg = np.asarray(jax.grad(lambda r: jfn(r).sum())(jnp.asarray(pts)))
    monkeypatch.setattr(tsdf._TorchMath, "clip", lambda self, x, lo, hi: torch.clamp(x, lo, hi))
    x = torch.as_tensor(pts).requires_grad_(True)
    g = torch.autograd.grad(tsdf.bolt_sdf_fn(SPEC)(x).sum(), x)[0].numpy()
    assert np.abs(g - jg).max() > 0.1, "the crest probes do not reach the clip's tie"


# ---------------------------------------------------------------------------
# the SDF zoo

def _mods(pkg):
    return [importlib.import_module(f"{pkg}.{m}")
            for m in ("assets.primitives", "assets.sdf", "assets.urdf", "core.config",
                      "core.scene")]


def sdf_zoo(pkg):
    """(scene, state, params) of one env: the bolt (closed form, static),
    the nut stand-in (voxel), a box whose SDF is numpy-only (voxel) and a
    tetrahedron without an SDF, free bodies, no ground."""
    prim, sdf, urdf, cfg, sc = _mods(pkg)
    fn, lo, hi = FN_CASES["bolt"](sdf)
    bolt = prim.create_mesh_asset("bolt", *sdf.bolt_mesh(SPEC), density=7800.0,
                                  sdf=sdf.sdf_from_fn(fn, lo, hi), fix_base_link=True)
    nut = urdf.load_urdf(NUT_STANDIN_ROOT, NUT_URDF, density=7800.0)
    bv, bf = box_mesh((0.03, 0.02, 0.025))
    box = prim.create_mesh_asset("sdfbox", bv, bf, density=500.0,
                                 sdf=sdf.sdf_from_fn(lambda p: box_sdf(p, np.array(
                                     [0.03, 0.02, 0.025], np.float32)), *bv[[0, -1]]))
    # 40 probes: padded to the 256 of the others with the far sentinel
    tetra = prim.create_mesh_asset("tetra", *tetra_mesh(), density=500.0, n_samples=40)
    b = sc.SceneBuilder(cfg.SimParams(dt=1 / 120, substeps=2))
    b.create_env((-1, -1, 0), (1, 1, 1), 1)
    for k, a in enumerate((bolt, nut, box, tetra)):
        b.create_actor(0, a, pos=(0.1 * k, 0, 0.5), name=f"o{k}")
    return b.finalize() if pkg == JAX else b.finalize("cpu")


def _zoo_poses(B, seed=21):
    """96 pose sets of B bodies within 0.03 m of each other around
    (0, 0, 0.5), random orientations."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-0.03, 0.03, (N_POSES, B, 3)).astype(np.float32)
    pos[..., 2] += 0.5
    q = rng.normal(size=(N_POSES, B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return pos, q.astype(np.float32)


@pytest.fixture(scope="module")
def zoo():
    jscene, _, jparams = sdf_zoo(JAX)
    scene, _, _ = sdf_zoo(PORT)
    from test_isaacgym_tpu.physics.contacts import ContactSolver as JCS
    from test_isaacgym_tpu_torch.physics.contacts import ContactSolver as TCS

    jc, c = JCS(jscene), TCS(scene, device="cpu")
    pos, quat = _zoo_poses(jscene.num_bodies_per_env)
    p = _batch_params(jparams, N_POSES, np.random.RandomState(22))
    jp = type(jparams)(**{k: None if v is None else jnp.asarray(v) for k, v in p.items()})
    want = jc.narrowphase(jnp.asarray(pos), jnp.asarray(quat), jp)
    got = c.narrowphase(torch.as_tensor(pos), torch.as_tensor(quat),
                        from_numpy(p, PhysParams, "cpu"))
    return jc, c, [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_zoo_table_matches_jax(zoo):
    """The same rows, both families present, the same stacked grids and
    padded probes."""
    jc, c = zoo[:2]
    for f in ("kind", "shape_a", "shape_b", "slot"):
        np.testing.assert_array_equal(getattr(c.job, f), getattr(jc.job, f), f)
    assert len(c.sdf_voxel_q) and len(c.sdf_analytic_groups)
    assert c.sdf_data.shape[0] == 2  # the nut's and the box's grids; the bolt's stays home
    np.testing.assert_array_equal(c.sdf_data, np.asarray(jc.sdf_data))
    np.testing.assert_array_equal(c.sdf_probes, np.asarray(jc.sdf_probes))
    np.testing.assert_array_equal(c.sdf_voxel_grid, jc.sdf_voxel_grid)
    assert (c.sdf_probes == 1e3).any()  # the far sentinel pads the short sets


def test_trilinear_matches_jax(zoo):
    from test_isaacgym_tpu.physics.contacts import _sdf_trilinear as jtri
    from test_isaacgym_tpu_torch.physics.contacts import _sdf_trilinear

    jc, c = zoo[:2]
    t = c._tables(torch.device("cpu")).sdf
    gid = jc.sdf_voxel_grid
    rng = np.random.RandomState(9)
    lo = jc.sdf_origin[gid]
    hi = lo + jc.sdf_spacing[gid] * (jc.sdf_data.shape[1] - 1)
    # (N, Qv, P, 3): uniform over each grid's box grown by a quarter on every
    # side, so a share of the queries lies outside
    u = rng.uniform(-0.25, 1.25, (8, len(gid), 64, 3))
    x = (lo[None, :, None] + u * (hi - lo)[None, :, None]).astype(np.float32)
    outside = ((u < 0) | (u > 1)).any(-1)
    assert outside.mean() > 0.5 and (~outside).sum() > 100
    phi, n = jtri(jc.sdf_data, jc.sdf_origin, jc.sdf_spacing, gid, jnp.asarray(x))
    tphi, tn = _sdf_trilinear(t, torch.as_tensor(x))
    close_rel(tphi.numpy(), np.asarray(phi), "phi")
    close_rel(tn.numpy(), np.asarray(n), "normal")


@pytest.mark.parametrize("out", ["point", "normal", "depth"])
def test_sdf_narrowphase_matches_jax(zoo, out):
    jc, c, want, got = zoo
    rows = np.nonzero(jc.job.kind == K_PT_SDF)[0]
    k = ("point", "normal", "depth").index(out)
    close_rel(got[k][:, rows], want[k][:, rows], f"K_PT_SDF {out}")
    if out == "depth":
        assert (want[2][:, rows] > 0).any()
        off = jc.scene.sim_params.physx.contact_offset
        differ = want[3][:, rows] != got[3][:, rows]
        assert not (differ & (np.abs(want[2][:, rows] + off) > 1e-5)).any(), "active"

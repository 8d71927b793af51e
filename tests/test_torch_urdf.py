"""Port parity: the URDF importer against the JAX package.

The mesh-free Panda stand-in loads to the same AssetSpec numbers in both
packages (links, inertials, joints, limits, dof properties), with and without
collapse_fixed; primitive geometry parses alike; <sdf> collision on a mesh
gives the JAX package's grid (bitwise), probes and resolution, and on a box
is ignored by both; and <fem> soft-body links load the JAX package's tet
mesh, materials and origin; use_mesh_materials takes an OBJ's MTL colors
as the JAX package does. <mesh> geometry is held by
tests/test_torch_mesh.py.
"""
import numpy as np
import pytest

from test_isaacgym_tpu.assets import load_urdf as jax_load_urdf
from test_isaacgym_tpu_torch.assets import load_urdf
from test_isaacgym_tpu_torch.envs.franka import FRANKA_URDF, STANDIN_ROOT


def _same_asset(got, want):
    assert got.name == want.name and got.fix_base_link == want.fix_base_link
    assert got.rigid_body_names() == want.rigid_body_names()
    assert got.dof_names() == want.dof_names() and got.dof_types() == want.dof_types()
    for a, b in zip(got.links, want.links):
        assert (a.parent, a.explicit_inertial) == (b.parent, b.explicit_inertial), a.name
        np.testing.assert_array_equal(a.mass, b.mass)
        np.testing.assert_array_equal(a.com, b.com)
        np.testing.assert_array_equal(a.inertia, b.inertia)
        assert (a.joint is None) == (b.joint is None)
        if a.joint is not None:
            assert vars(a.joint) == vars(b.joint), a.name
        assert len(a.geoms) == len(b.geoms) and len(a.visuals) == len(b.visuals)
        for ga, gb in zip(a.geoms + a.visuals, b.geoms + b.visuals):
            assert (ga.kind, ga.size, ga.pos, ga.quat, ga.color) == (
                gb.kind, gb.size, gb.pos, gb.quat, gb.color)
    for f in got.dof_properties().dtype.names:
        np.testing.assert_array_equal(got.dof_properties()[f], want.dof_properties()[f], f)


@pytest.mark.parametrize("collapse", [False, True])
@pytest.mark.parametrize("fixed", [True, False])
def test_standin_loads_like_jax(fixed, collapse):
    kw = dict(fix_base_link=fixed, collapse_fixed=collapse, armature=0.01)
    got = load_urdf(STANDIN_ROOT, FRANKA_URDF, **kw)
    _same_asset(got, jax_load_urdf(STANDIN_ROOT, FRANKA_URDF, **kw))
    names = got.rigid_body_names()
    if not collapse:
        assert len(names) == 12 and got.num_dofs == 9
        assert names[:9] == [f"panda_link{i}" for i in range(9)]
        assert names[9:] == ["panda_hand", "panda_leftfinger", "panda_rightfinger"]
    assert all(not link.geoms and not link.visuals for link in got.links)


_PRIMITIVES = """<?xml version="1.0"?>
<robot name="prims">
  <link name="a">
    <collision><origin xyz="0 0 0.1" rpy="0.1 0.2 0.3"/><geometry><box size="0.2 0.4 0.6"/></geometry></collision>
    <visual><geometry><sphere radius="0.3"/></geometry><material name="m"><color rgba="0.1 0.2 0.3 1"/></material></visual>
  </link>
  <link name="b">
    <collision><geometry><capsule radius="0.05" length="0.3"/></geometry></collision>
    <collision><geometry><cylinder radius="0.07" length="0.2"/></geometry></collision>
  </link>
  <link name="c"><collision><geometry><sphere radius="0.1"/></geometry></collision></link>
  <joint name="ab" type="continuous"><parent link="a"/><child link="b"/><axis xyz="0 0 2"/>
    <dynamics damping="0.5" friction="0.2"/></joint>
  <joint name="bc" type="prismatic"><parent link="b"/><child link="c"/>
    <origin xyz="0.1 0 0"/><limit lower="-0.1" upper="0.2" effort="30" velocity="1"/></joint>
</robot>
"""


def test_primitive_geometry_and_default_inertia_like_jax(tmp_path):
    (tmp_path / "prims.urdf").write_text(_PRIMITIVES)
    got = load_urdf(str(tmp_path), "prims.urdf", density=500.0)
    _same_asset(got, jax_load_urdf(str(tmp_path), "prims.urdf", density=500.0))
    assert got.links[0].geoms[0].color == (0.1, 0.2, 0.3)  # visual color carried over


@pytest.mark.parametrize("element,what", [
    ('<visual><geometry><box size="1 1 1"/></geometry></visual>'
     '<fem><tetmesh filename="part.tet"/></fem>', "<fem>"),
    ('<fem><tetmesh filename="part.tet"/></fem>', "<fem>"),
])
def test_unported_elements_raise(tmp_path, element, what):
    """<fem> links are ported (the name is the test's from before, when they
    raised): the tet mesh, the material defaults and the origin load as in
    the JAX package, and a link with no geometry becomes the massless
    placeholder (mass 1e-3)."""
    (tmp_path / "part.tet").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nv 1 1 1\nt 0 1 2 3\nt 1 2 3 4\n")
    (tmp_path / "x.urdf").write_text(
        f'<robot name="x"><link name="a">{element}</link></robot>'
    )
    got, want = load_urdf(str(tmp_path), "x.urdf"), jax_load_urdf(str(tmp_path), "x.urdf")
    _same_asset(got, want)
    a, b = got.links[0].fem, want.links[0].fem
    assert a is not None and b is not None, what
    for f in ("verts", "tets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert {k: v for k, v in vars(a).items() if k not in ("verts", "tets")} == {
        k: v for k, v in vars(b).items() if k not in ("verts", "tets")}
    if not got.links[0].visuals:
        assert got.links[0].mass == 1e-3


_WEDGE_OBJ = """v -0.03 -0.02 -0.01
v 0.03 -0.02 -0.01
v -0.03 0.02 -0.01
v 0.03 0.02 -0.01
v -0.03 -0.02 0.03
v 0.03 -0.02 0.01
v -0.03 0.02 0.03
v 0.03 0.02 0.01
f 1 3 4
f 1 4 2
f 5 6 8
f 5 8 7
f 1 2 6
f 1 6 5
f 3 7 8
f 3 8 4
f 1 5 7
f 1 7 3
f 2 4 8
f 2 8 6
"""


@pytest.mark.parametrize("element", [
    '<collision><origin xyz="0 0 0.05"/><geometry><mesh filename="part.obj"/></geometry>'
    '<sdf resolution="256"/></collision>',
    '<collision><geometry><box size="1 1 1"/></geometry><sdf resolution="64"/></collision>',
], ids=["mesh", "box"])
def test_sdf_collision_like_jax(tmp_path, monkeypatch, element):
    """<sdf> in a collision element: on a mesh, a grid of the full mesh
    (quantized to SDF_RES, bitwise the JAX package's) and 256 surface
    probes taken before hulling; on a primitive, ignored by both."""
    import test_isaacgym_tpu.assets.sdf as jsdf
    import test_isaacgym_tpu_torch.assets.sdf as tsdf

    monkeypatch.setattr(jsdf, "_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(tsdf, "_CACHE_DIR", str(tmp_path / "torch_cache"))
    (tmp_path / "part.obj").write_text(_WEDGE_OBJ)
    (tmp_path / "x.urdf").write_text(f'<robot name="x"><link name="a">{element}</link></robot>')
    got = load_urdf(str(tmp_path), "x.urdf")
    want = jax_load_urdf(str(tmp_path), "x.urdf")
    _same_asset(got, want)
    g, w = got.links[0].geoms[0], want.links[0].geoms[0]
    assert g.sdf_resolution == w.sdf_resolution
    if g.kind != "mesh":
        assert g.sdf is None and w.sdf is None and g.sdf_samples is None
        return
    assert g.sdf_resolution == 256 and g.sdf.data.shape == (tsdf.SDF_RES,) * 3
    for f in ("data", "origin", "spacing"):
        np.testing.assert_array_equal(getattr(g.sdf, f), getattr(w.sdf, f), f)
    np.testing.assert_array_equal(g.sdf_samples, w.sdf_samples)
    assert g.sdf_samples.shape == (256, 3) and g.sdf.analytic is None
    np.testing.assert_array_equal(g.center(), w.center())


_MATERIAL_URDF = """<robot name="painted">
  <link name="a">
    <visual><geometry><mesh filename="{obj}"/></geometry>
      <material name="grey"><color rgba="0.5 0.5 0.5 1"/></material></visual>
    <collision><geometry><mesh filename="{obj}"/></geometry></collision>
  </link>
</robot>
"""
_CUBE_OBJ = "".join(f"v {x} {y} {z}\n" for x in (0, 0.1) for y in (0, 0.1) for z in (0, 0.1)) + (
    "f 1 2 4\nf 1 4 3\nf 5 7 8\nf 5 8 6\nf 1 5 6\nf 1 6 2\n"
    "f 3 4 8\nf 3 8 7\nf 1 3 7\nf 1 7 5\nf 2 6 8\nf 2 8 4\n")


@pytest.mark.parametrize("mtl", ["good", "unparsable", "missing"])
@pytest.mark.parametrize("use", [False, True])
def test_use_mesh_materials_like_jax(tmp_path, mtl, use):
    """use_mesh_materials: an OBJ's MTL diffuse colors (their mean) win over
    the URDF material, on the visual and the collision geom it colors; an
    MTL that does not parse or is missing keeps the URDF color (the JAX
    package's best-effort reading)."""
    (tmp_path / "cube.obj").write_text("mtllib cube.mtl\n" + _CUBE_OBJ)
    if mtl != "missing":
        kd = "Kd 1.0 0.2 0.0\nKd 0.6 0.4 0.2\n" if mtl == "good" else "Kd one two three\n"
        (tmp_path / "cube.mtl").write_text("newmtl red\n" + kd)
    (tmp_path / "p.urdf").write_text(_MATERIAL_URDF.format(obj="cube.obj"))
    got = load_urdf(str(tmp_path), "p.urdf", use_mesh_materials=use)
    want = jax_load_urdf(str(tmp_path), "p.urdf", use_mesh_materials=use)
    _same_asset(got, want)
    expect = (0.8, 0.3, 0.1) if use and mtl == "good" else (0.5, 0.5, 0.5)
    for g in got.links[0].visuals + got.links[0].geoms:
        assert g.color == pytest.approx(expect)

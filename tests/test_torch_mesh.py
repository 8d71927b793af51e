"""Port parity: mesh loading into convex hulls against the JAX package.

Meshes are written by the tests to `tmp_path` (no asset of the reference is
read): a tetrahedron-capped box as OBJ (quads and a fan polygon), binary
and ASCII STL, and COLLADA (DAE) with <triangles> and <polylist>.
  * `load_mesh` gives the same vertices and faces as the JAX package's, for
    each format, and (None, None) for a missing file;
  * `convex_hull_vertices` gives the same vertex set, with and without the
    farthest-point decimation;
  * `create_mesh_asset` and `<mesh>` geometry in `load_urdf` (a
    `package://` path, `scale`, `max_hull_verts`, `load_meshes=False`) give
    the same AssetSpec arrays: hull vertices, faces, surface probes, the
    visual mesh, sizes, poses and inertials.
"""
import struct

import numpy as np
import pytest

from test_isaacgym_tpu.assets import mesh as jmesh
from test_isaacgym_tpu.assets import primitives as jprim
from test_isaacgym_tpu.assets.urdf import load_urdf as jax_load_urdf
from test_isaacgym_tpu_torch.assets import mesh as tmesh
from test_isaacgym_tpu_torch.assets import primitives as tprim
from test_isaacgym_tpu_torch.assets.urdf import load_urdf

# a box of half extents (0.1, 0.05, 0.2) with a pyramid on its top face
_VERTS = np.array([[x, y, z] for x in (-0.1, 0.1) for y in (-0.05, 0.05) for z in (-0.2, 0.2)]
                  + [[0.0, 0.0, 0.35]], np.float32)
_QUADS = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4)]
_TRIS = [(1, 5, 8), (5, 7, 8), (7, 3, 8), (3, 1, 8)]


def _triangles():
    faces = []
    for q in _QUADS:
        faces += [(q[0], q[1], q[2]), (q[0], q[2], q[3])]
    return np.asarray(faces + _TRIS, np.int32)


def _write_obj(path):
    lines = [f"v {x} {y} {z}" for x, y, z in _VERTS] + ["vn 0 0 1", "vt 0 0"]
    lines += ["f " + " ".join(f"{i + 1}/1/1" for i in q) for q in _QUADS]
    lines += ["f " + " ".join(str(i + 1) for i in t) for t in _TRIS]
    path.write_text("\n".join(lines) + "\n")


def _write_stl_binary(path):
    tri = _VERTS[_triangles()]
    with open(path, "wb") as f:
        f.write(b"binary stl written by a test".ljust(80, b" "))
        f.write(struct.pack("<I", len(tri)))
        for t in tri:
            f.write(struct.pack("<3f", 0.0, 0.0, 1.0) + t.astype("<f4").tobytes() + b"\0\0")


def _write_stl_ascii(path):
    out = ["solid part"]
    for t in _VERTS[_triangles()]:
        out += ["facet normal 0 0 1", " outer loop"]
        out += [f"  vertex {x} {y} {z}" for x, y, z in t]
        out += [" endloop", "endfacet"]
    path.write_text("\n".join(out + ["endsolid part"]) + "\n")


def _write_dae(path):
    """Two geometries in centimetres: the box as a <polylist> of quads, the
    pyramid as <triangles>, each with an interleaved normal stream."""
    box = " ".join(f"{v:g}" for v in (_VERTS[:8] * 100).ravel())
    top = " ".join(f"{v:g}" for v in (_VERTS[[1, 3, 5, 7, 8]] * 100).ravel())
    quads = " ".join(f"{i} 0" for q in _QUADS for i in q)
    pyr = " ".join(f"{i} 0" for t in ((0, 2, 4), (2, 3, 4), (3, 1, 4), (1, 0, 4)) for i in t)

    def geom(name, pos, n, prim):
        return f"""<geometry id="{name}"><mesh>
  <source id="{name}-pos"><float_array id="{name}-arr" count="{3 * n}">{pos}</float_array></source>
  <source id="{name}-nrm"><float_array id="{name}-narr" count="3">0 0 1</float_array></source>
  <vertices id="{name}-v"><input semantic="POSITION" source="#{name}-pos"/></vertices>
  {prim}
</mesh></geometry>"""

    body = (geom("box", box, 8, f'<polylist count="5"><input semantic="VERTEX" source="#box-v" '
                 f'offset="0"/><input semantic="NORMAL" source="#box-nrm" offset="1"/>'
                 f'<vcount>4 4 4 4 4</vcount><p>{quads}</p></polylist>')
            + geom("top", top, 5, f'<triangles count="4"><input semantic="VERTEX" '
                   f'source="#top-v" offset="0"/><input semantic="NORMAL" source="#top-nrm" '
                   f'offset="1"/><p>{pyr}</p></triangles>'))
    path.write_text(
        '<?xml version="1.0"?><COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema">'
        '<asset><unit meter="0.01"/></asset><library_geometries>' + body
        + "</library_geometries></COLLADA>")


WRITERS = {"obj": (_write_obj, ".obj"), "stl_binary": (_write_stl_binary, ".stl"),
           "stl_ascii": (_write_stl_ascii, ".stl"), "dae": (_write_dae, ".dae")}


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_load_mesh_matches_jax(tmp_path, fmt):
    write, ext = WRITERS[fmt]
    path = tmp_path / f"part{ext}"
    write(path)
    got, want = tmesh.load_mesh(str(path)), jmesh.load_mesh(str(path))
    assert want[0] is not None and want[1] is not None, fmt
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # every format reads the same solid
    lo, hi = got[0].min(0), got[0].max(0)
    np.testing.assert_allclose(lo, [-0.1, -0.05, -0.2], atol=1e-6)
    np.testing.assert_allclose(hi, [0.1, 0.05, 0.35], atol=1e-6)
    assert tmesh.load_mesh(str(tmp_path / f"missing{ext}")) == (None, None)


@pytest.mark.parametrize("max_verts", [64, 12])
def test_convex_hull_vertices_match_jax(max_verts):
    """200 seeded points in a ball: about 60 of them on the hull, which the
    budget of 12 decimates by farthest-point sampling."""
    pts = np.random.RandomState(8).normal(size=(200, 3)).astype(np.float32)
    got = tmesh.convex_hull_vertices(pts, max_verts)
    want = jmesh.convex_hull_vertices(pts, max_verts)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert len(got) <= max_verts


def _same_mesh_geom(g, w):
    assert (g.kind, g.size, g.pos, g.quat, g.mesh_path, g.mesh_scale) == (
        w.kind, w.size, w.pos, w.quat, w.mesh_path, w.mesh_scale)
    for f in ("vertices", "faces", "sdf_samples", "visual_vertices", "visual_faces"):
        a, b = getattr(g, f), getattr(w, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, f)


def _same_links(got, want):
    assert got.name == want.name and len(got.links) == len(want.links)
    for a, b in zip(got.links, want.links):
        np.testing.assert_array_equal(a.mass, b.mass)
        np.testing.assert_array_equal(a.com, b.com)
        np.testing.assert_array_equal(a.inertia, b.inertia)
        assert len(a.geoms) == len(b.geoms) and len(a.visuals) == len(b.visuals)
        for ga, gb in zip(a.geoms + a.visuals, b.geoms + b.visuals):
            _same_mesh_geom(ga, gb)


def test_create_mesh_asset_matches_jax():
    pts = np.random.RandomState(9).normal(size=(300, 3)).astype(np.float32) * [0.1, 0.05, 0.03]
    faces = np.random.RandomState(9).randint(0, 300, (50, 3))
    kw = dict(density=400.0, n_samples=32, max_hull_verts=24)
    got = tprim.create_mesh_asset("rock", pts, faces, **kw)
    _same_links(got, jprim.create_mesh_asset("rock", pts, faces, **kw))
    assert len(got.links[0].geoms[0].vertices) == 24


_MESH_URDF = """<robot name="parts">
  <link name="base">
    <collision><origin xyz="0.01 0 0.02" rpy="0 0.3 0"/>
      <geometry><mesh filename="package://parts/meshes/part.obj" scale="2 1 0.5"/></geometry>
    </collision>
    <visual><geometry><mesh filename="meshes/part.stl"/></geometry></visual>
  </link>
  <link name="lid">
    <collision><geometry><mesh filename="../parts/meshes/part.dae"/></geometry></collision>
  </link>
  <joint name="hinge" type="revolute"><parent link="base"/><child link="lid"/>
    <axis xyz="0 1 0"/><limit lower="-1" upper="1" effort="5" velocity="2"/></joint>
</robot>
"""


@pytest.mark.parametrize("load_meshes,max_hull_verts", [(True, 64), (True, 6), (False, 64)])
def test_urdf_mesh_geometry_matches_jax(tmp_path, load_meshes, max_hull_verts):
    """<mesh> collision and visual geometry: a package:// path resolved
    against the asset root, scale, paths relative to the URDF, hulling
    with max_hull_verts, and load_meshes=False (paths only)."""
    meshes = tmp_path / "parts" / "meshes"
    meshes.mkdir(parents=True)
    _write_obj(meshes / "part.obj")
    _write_stl_binary(meshes / "part.stl")
    _write_dae(meshes / "part.dae")
    (tmp_path / "parts" / "parts.urdf").write_text(_MESH_URDF)
    kw = dict(load_meshes=load_meshes, max_hull_verts=max_hull_verts, density=300.0)
    got = load_urdf(str(tmp_path), "parts/parts.urdf", **kw)
    _same_links(got, jax_load_urdf(str(tmp_path), "parts/parts.urdf", **kw))
    g = got.links[0].geoms[0]
    assert g.mesh_path == str(meshes / "part.obj") and g.mesh_scale == (2.0, 1.0, 0.5)
    if load_meshes:
        assert len(g.vertices) == min(9, max_hull_verts)
        assert g.visual_vertices is not None and float(g.vertices[:, 0].max()) > 0.15
    else:
        assert g.vertices is None

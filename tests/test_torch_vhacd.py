"""Port parity: convex decomposition (assets/vhacd.py) against the JAX
package, through the repository's native tool (native/build/vhacd_tool).

A concave mesh made here (a U-shaped block, written as an OBJ under a URDF
in tmp_path) is decomposed by both packages into separate temporary caches:
the hulls are bitwise equal, a second call reads them back from the cache,
and the decomposed asset becomes several hull shapes that step like the
JAX package's (op by op) at 1e-4 * max(|ref|, 1). Where the JAX package
falls back to a single hull, the port raises with the tool's stderr.
"""
import contextlib
import os
import stat
import subprocess

import jax
import numpy as np
import pytest

import test_isaacgym_tpu  # noqa: F401  (CPU platform before jax init)
import test_isaacgym_tpu.assets.vhacd as jv
import test_isaacgym_tpu_torch.assets.vhacd as tv
from test_isaacgym_tpu.assets.urdf import load_urdf as jax_load_urdf
from test_isaacgym_tpu.core.config import PlaneParams as JaxPlane
from test_isaacgym_tpu.core.config import SimParams as JaxSimParams
from test_isaacgym_tpu.core.scene import SceneBuilder as JaxBuilder
from test_isaacgym_tpu.core.sim import Simulator as JaxSimulator
from test_isaacgym_tpu_torch.assets import load_urdf
from test_isaacgym_tpu_torch.core.config import PlaneParams, SimParams, VhacdParams
from test_isaacgym_tpu_torch.core.scene import SHAPE_MESH, SceneBuilder
from test_isaacgym_tpu_torch.core.sim import Simulator
from test_isaacgym_tpu_torch.core.state import to_numpy

TOL = 1e-4
PARAMS = VhacdParams(max_convex_hulls=8, max_num_vertices_per_ch=32)

URDF = """<robot name="u">
  <link name="u">
    <inertial><mass value="0.5"/><inertia ixx="1e-3" iyy="1e-3" izz="1e-3" ixy="0" ixz="0" iyz="0"/></inertial>
    <visual><geometry><mesh filename="u.obj"/></geometry></visual>
    <collision><geometry><mesh filename="u.obj"/></geometry></collision>
  </link>
</robot>
"""


def u_block():
    """A U-shaped prism with thin walls: outline (0,0)-(3,0)-(3,2)-(2.5,2)-
    (2.5,0.5)-(0.5,0.5)-(0.5,2)-(0,2) x 0.1 m in the xz plane, 0.1 m deep
    along y; closed, outward faces. Its cavity is half its hull."""
    out2d = np.array([[0, 0], [3, 0], [3, 2], [2.5, 2], [2.5, 0.5], [0.5, 0.5], [0.5, 2],
                      [0, 2]], np.float32) * 0.1
    tris2d = [[1, 2, 3], [1, 3, 4], [0, 1, 4], [0, 4, 5], [0, 5, 6], [0, 6, 7]]
    v = np.asarray([[p[0], y, p[1]] for y in (-0.05, 0.05) for p in out2d], np.float32)
    n = len(out2d)
    f = [[a, b, c] for a, b, c in tris2d] + [[a + n, c + n, b + n] for a, b, c in tris2d]
    for i in range(n):
        j = (i + 1) % n
        f += [[i, j + n, j], [i, i + n, j + n]]
    return v, np.asarray(f, np.int32)


@contextlib.contextmanager
def caches(tmp_path):
    saved = jv._CACHE_DIR, tv._CACHE_DIR
    jv._CACHE_DIR, tv._CACHE_DIR = str(tmp_path / "jax_cache"), str(tmp_path / "torch_cache")
    try:
        yield
    finally:
        jv._CACHE_DIR, tv._CACHE_DIR = saved


@pytest.fixture
def mesh_dir(tmp_path):
    v, f = u_block()
    with open(tmp_path / "u.obj", "w") as fh:
        fh.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in v)
        fh.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f)
    (tmp_path / "u.urdf").write_text(URDF)
    return tmp_path


def test_tool_is_committed_and_runs():
    """With no arguments the committed tool prints its usage and exits 2."""
    out = subprocess.run([tv._TOOL], capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "usage" in out.stderr + out.stdout


def test_decompose_mesh_like_jax_and_cached(tmp_path):
    v, f = u_block()
    with caches(tmp_path):
        want = jv.decompose_mesh(v, f, PARAMS)
        got = tv.decompose_mesh(v, f, PARAMS)
        assert len(got) == len(want) >= 2  # concave: more than one hull
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for d in (jv._CACHE_DIR, tv._CACHE_DIR):  # each package its own cache
            assert any(n.endswith(".npz") for n in os.listdir(d)), d
        again = tv.decompose_mesh(v, f, PARAMS)  # read back from the cache
        for g, w in zip(again, got):
            np.testing.assert_array_equal(g, w)


def test_tool_failure_raises(tmp_path):
    """The port raises with the tool's stderr, where the JAX package keeps
    one hull of the mesh."""
    v, f = u_block()
    bad = tmp_path / "failing_tool"
    bad.write_text("#!/bin/sh\necho 'cannot decompose this mesh' >&2\nexit 3\n")
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    saved = jv._TOOL, tv._TOOL
    jv._TOOL, tv._TOOL = str(bad), str(bad)
    try:
        with caches(tmp_path):
            assert len(jv.decompose_mesh(v, f, PARAMS)) == 1
            with pytest.raises(RuntimeError, match="cannot decompose this mesh"):
                tv.decompose_mesh(v, f, PARAMS)
            tv._TOOL = str(tmp_path / "missing_tool")
            with pytest.raises(RuntimeError, match="not built"):
                tv.decompose_mesh(v * 2, f, PARAMS)
    finally:
        jv._TOOL, tv._TOOL = saved


def _sims(mesh_dir):
    out = []
    for Builder, Sim, Plane, Params, load, mod in (
            (JaxBuilder, JaxSimulator, JaxPlane, JaxSimParams, jax_load_urdf, jv),
            (SceneBuilder, Simulator, PlaneParams, SimParams, load_urdf, tv)):
        asset = load(str(mesh_dir), "u.urdf")
        mod.decompose_asset(asset, PARAMS)
        b = Builder(Params(dt=1 / 60, substeps=2))
        b.add_ground(Plane())
        for i in range(2):
            b.create_env((-1, -1, 0), (1, 1, 1), 2)
            b.create_actor(i, asset, pos=(0, 0, 0.05 + 0.02 * i), quat=(0.1, 0, 0, 0.995),
                           name="u", group=i, filter=0)
        out.append(Sim(*b.finalize()) if Sim is JaxSimulator
                   else Sim(*b.finalize("cpu"), device="cpu"))
    return out


def test_decomposed_asset_steps_as_hulls_like_jax(mesh_dir, tmp_path):
    with caches(tmp_path):
        jsim, tsim = _sims(mesh_dir)
    kinds = tsim.scene.shapes.kind
    assert (kinds == SHAPE_MESH).sum() >= 2 and len(tsim.scene.hulls) >= 2
    np.testing.assert_array_equal(kinds, jsim.scene.shapes.kind)
    for h_t, h_j in zip(tsim.scene.hulls, jsim.scene.hulls):
        np.testing.assert_array_equal(h_t, h_j)
    js, ts = jsim.state, tsim.state
    for k in range(4):
        with jax.disable_jit():
            js = jsim.stepper.step(js, jsim.actions, jsim.params)
        ts = tsim.stepper.step(ts, tsim.actions, tsim.params)
        got = to_numpy(ts)
        for key in ("root_pos", "root_quat", "root_linvel", "root_angvel"):
            want = np.asarray(getattr(js, key))
            assert np.abs(got[key] - want).max() <= TOL * max(np.abs(want).max(), 1.0), (k, key)

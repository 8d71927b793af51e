"""The port stands alone: it imports no jax and nothing of the JAX package,
and its entry points default to the GPU.

tests/conftest.py imports jax into the test process, so the import check
runs in a fresh interpreter.
"""
import ast
import dataclasses
import inspect
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "test_isaacgym_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import test_isaacgym_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "test_isaacgym_tpu" or m.startswith("test_isaacgym_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_import_loads_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20  # every submodule was imported


def test_import_walk_reaches_the_sdf_modules():
    """The walk above imports the SDF, soft-body, RL-env and renderer slices,
    the gymapi facade with its compat modules, and the env-axis sharding
    too: their modules are in the package tree."""
    import pkgutil

    import test_isaacgym_tpu_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    for mod in ("assets.sdf", "envs.nut_bolt", "envs.franka_nut_bolt", "physics.contacts",
                "physics.soft", "envs.soft_body", "assets.mjcf", "assets.vhacd", "randomize",
                "envs.rl_env", "render.raster", "render.meshtools", "render.camera",
                "gymapi", "gymapi.facade", "gymapi.mathtypes", "gymtorch", "gymutil",
                "torch_utils", "envs.gym_scenes", "parallel", "parallel.mesh"):
        assert f"test_isaacgym_tpu_torch.{mod}" in names, mod


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_name_no_jax_import():
    files = sorted(PKG.rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "test_isaacgym_tpu"), f"{f}: imports {mod}"


def test_entry_points_default_to_cuda():
    from test_isaacgym_tpu_torch.core.scene import SceneBuilder
    from test_isaacgym_tpu_torch.core.sim import Simulator, make_sim
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv
    from test_isaacgym_tpu_torch.envs.franka import FrankaOscEnv
    from test_isaacgym_tpu_torch.envs.franka_cube import FrankaCubeEnv
    from test_isaacgym_tpu_torch.envs.franka_nut_bolt import FrankaNutBoltEnv
    from test_isaacgym_tpu_torch.envs.nut_bolt import NutBoltEnv
    from test_isaacgym_tpu_torch.envs.soft_body import pedestals_sim, soft_body_sim
    from test_isaacgym_tpu_torch.envs.rl_env import AntVecEnv, FrankaReachVecEnv, make
    from test_isaacgym_tpu_torch.envs.uav_car import UavCarEnv
    from test_isaacgym_tpu_torch.physics.soft import SoftStepper
    from test_isaacgym_tpu_torch.physics.step import Stepper
    from test_isaacgym_tpu_torch.randomize import randomize_camera_pose, randomize_light
    from test_isaacgym_tpu_torch.render.camera import CameraSensor

    for env in (BallsEnv, UavCarEnv, FrankaOscEnv, FrankaCubeEnv, NutBoltEnv, FrankaNutBoltEnv):
        fields = {f.name: f.default for f in dataclasses.fields(env)}
        assert fields["device"] == "cuda", env
    for fn in (Simulator.__init__, SceneBuilder.finalize, Stepper.__init__, make_sim,
               SoftStepper.__init__, soft_body_sim, pedestals_sim, AntVecEnv.__init__,
               FrankaReachVecEnv.__init__, randomize_light, randomize_camera_pose):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert {f.name: f.default for f in dataclasses.fields(CameraSensor)}["device"] == "cuda"
    for arg in ("sim_device", "rl_device"):
        assert inspect.signature(make).parameters[arg].default == "cuda:0"
    from test_isaacgym_tpu_torch import gymapi, gymutil, torch_utils

    sim = gymapi.acquire_gym().create_sim(1, 0, gymapi.SIM_PHYSX, gymapi.SimParams())
    assert sim.device == torch.device("cuda:1")
    assert gymapi.acquire_gym().create_sim().device == torch.device("cuda:0")
    assert inspect.signature(torch_utils.to_torch).parameters["device"].default == "cuda:0"
    assert gymutil.parse_arguments(args=[]).sim_device == "cuda:0"


def test_default_device_does_not_fall_back_to_cpu():
    """Without a GPU the default entry point fails; it never moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from test_isaacgym_tpu_torch import gymapi, torch_utils
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv

    with pytest.raises((RuntimeError, AssertionError)):
        BallsEnv(pyramids=4)
    gym = gymapi.acquire_gym()
    sim = gym.create_sim(0, 0, gymapi.SIM_PHYSX, gymapi.SimParams())
    env = gym.create_env(sim, gymapi.Vec3(-1, -1, 0), gymapi.Vec3(1, 1, 1), 1)
    gym.create_actor(env, gym.create_sphere(sim, 0.1), gymapi.Transform(), "ball")
    with pytest.raises((RuntimeError, AssertionError)):
        gym.prepare_sim(sim)
    with pytest.raises((RuntimeError, AssertionError)):
        torch_utils.to_torch([1.0])

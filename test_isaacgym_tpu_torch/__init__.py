"""test_isaacgym_tpu_torch — the PyTorch/CUDA port of test_isaacgym_tpu.

A second package beside the JAX one, with the same module layout and names:
the same scene build, the same state layout (torch tensors, env axis first)
and the same step, with every Pallas TPU kernel rewritten by hand for NVIDIA
Hopper (csrc/). The JAX package is the reference the port's tests hold it
against. Entry points take an explicit `device` and default to "cuda".

Ported so far: free and static bodies with the dense sphere-world and the
neighbor-list contact paths; articulations (kinematics, dense CRBA/RNEA
dynamics, the articulated step with attractors, the Simulator's Jacobian and
mass-matrix functions); the contact table of primitive shapes, convex hulls,
heightfield terrain and SDF probes (voxel grids and closed forms); FEM soft
bodies (the XPBD tet solve with one-way colliders, physics/soft.py); mesh
loading (OBJ, STL, DAE) into convex hulls, `create_mesh_asset` and the URDF
importer with <mesh> geometry, <sdf> collision, <fem> links and mesh
materials; the MJCF importer (assets/mjcf.py); convex decomposition through
the native VHACD tool (assets/vhacd.py); the SDF grids and the procedural
bolt (assets/sdf.py); the terrain_utils generators; domain randomization
(randomize.py, drawn from a torch.Generator); OSC/IK control, CCLVF
guidance, the visual servo; cameras (render/camera.py: CameraSensor and the
projection) and the batched ray-cast renderer (render/raster.py:
primitives, hulls, visual triangle meshes, soft surfaces, debug lines,
textures, per-env fov, supersampling, the frustum cull, optical flow); the
TIG_DEBUG checks (utils/debug.py); and the envs and scenes that drive them:
  - `test_isaacgym_tpu_torch.envs.balls.BallsEnv`
  - `test_isaacgym_tpu_torch.envs.franka.FrankaOscEnv` (the flagship; its
    default asset is the mesh-free Panda stand-in in assets/data/)
  - `test_isaacgym_tpu_torch.envs.franka_cube.FrankaCubeEnv`
  - `test_isaacgym_tpu_torch.envs.uav_car.UavCarEnv`
  - `test_isaacgym_tpu_torch.envs.pile` (object piles on a ground or on
    the AnymalTerrain map)
  - `test_isaacgym_tpu_torch.envs.nut_bolt.NutBoltEnv` (a nut spun down the
    procedural bolt; its default asset is the code-built nut stand-in in
    assets/data/)
  - `test_isaacgym_tpu_torch.envs.franka_nut_bolt.FrankaNutBoltEnv` (the
    arm-driven pick, place and screw FSM)
  - `test_isaacgym_tpu_torch.envs.soft_body` (FEM tet icospheres on the
    XPBD solve: the reference's soft-body example and a pedestal scene;
    its default asset is the code-built icosphere stand-in in assets/data/)
  - `test_isaacgym_tpu_torch.envs.rl_env.make` (the isaacgymenvs.make
    surface: `AntVecEnv` on the code-written Ant stand-in in assets/data/,
    `FrankaReachVecEnv`; reset/step return tensors, render() a frame)
  - `test_isaacgym_tpu_torch.core.sim.Simulator`
  - `test_isaacgym_tpu_torch.core.scene.SceneBuilder`
  - `test_isaacgym_tpu_torch.gymapi` (the reference-compatible facade:
    `acquire_gym()`, handles, the classic and tensor state APIs, cameras,
    a headless viewer; its tensor handles live on the sim's device) with
    `gymtorch`, `gymutil` and `torch_utils`
  - `test_isaacgym_tpu_torch.parallel.mesh` (envs sharded over the ranks
    of `torch.distributed`, one process a device, the obs all-gather and
    the metric sums at the loop boundary: NCCL on the card, gloo on the CPU)
"""

__version__ = "0.1.0"

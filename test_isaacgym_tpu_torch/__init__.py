"""test_isaacgym_tpu_torch — the PyTorch/CUDA port of test_isaacgym_tpu.

A second package beside the JAX one, with the same module layout and names:
the same scene build, the same state layout (torch tensors, env axis first)
and the same step, with every Pallas TPU kernel rewritten by hand for NVIDIA
Hopper (csrc/). The JAX package is the reference the port's tests hold it
against. Entry points take an explicit `device` and default to "cuda".

Ported so far: free and static bodies with the dense sphere-world and the
neighbor-list contact paths; articulations (kinematics, dense CRBA/RNEA
dynamics, the articulated step with attractors, the Simulator's Jacobian and
mass-matrix functions); the contact table of primitive shapes; OSC/IK
control, CCLVF guidance, the visual servo and the camera projection; the
URDF importer without meshes; the TIG_DEBUG checks (utils/debug.py); and the
envs that drive them:
  - `test_isaacgym_tpu_torch.envs.balls.BallsEnv`
  - `test_isaacgym_tpu_torch.envs.franka.FrankaOscEnv` (the flagship; its
    default asset is the mesh-free Panda stand-in in assets/data/)
  - `test_isaacgym_tpu_torch.envs.franka_cube.FrankaCubeEnv`
  - `test_isaacgym_tpu_torch.envs.uav_car.UavCarEnv`
  - `test_isaacgym_tpu_torch.core.sim.Simulator`
  - `test_isaacgym_tpu_torch.core.scene.SceneBuilder`
Not ported yet, and raising NotImplementedError: meshes, convex hulls, SDF
contact and heightfields, soft bodies; rendering and the gym facade are not
in the package yet.
"""

__version__ = "0.1.0"

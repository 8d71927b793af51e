"""test_isaacgym_tpu_torch — the PyTorch/CUDA port of test_isaacgym_tpu.

A second package beside the JAX one, with the same module layout and names:
the same scene build, the same state layout (torch tensors, env axis first)
and the same step, with every Pallas TPU kernel rewritten by hand for NVIDIA
Hopper (csrc/). The JAX package is the reference the port's tests hold it
against. Entry points take an explicit `device` and default to "cuda".

Ported so far: free and static bodies with the dense sphere-world contact
path, and the env that drives it:
  - `test_isaacgym_tpu_torch.envs.balls.BallsEnv`
  - `test_isaacgym_tpu_torch.core.sim.Simulator`
  - `test_isaacgym_tpu_torch.core.scene.SceneBuilder`
"""

__version__ = "0.1.0"

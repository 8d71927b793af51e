"""Hot physics ops. Each op that the JAX package wrote as a Pallas TPU kernel
ships a hand-written CUDA kernel (csrc/) and its plain PyTorch version;
dispatch happens inside each op on the tensors' device."""

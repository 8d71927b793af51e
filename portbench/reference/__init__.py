"""The plain references that decide `correct`, one module a configuration
(`franka`, `balls`), written again in plain PyTorch from the arithmetic of
the JAX package's modules on the cells' paths (read, never imported), and
held to the JAX package's own recorded runs by portbench/tests. They
import nothing of the port or the JAX package, and take only the
configuration, the seed's inputs and the raw files both sides read (the
arm's URDF). `precision` puts a reference in the lower precision of the
control."""

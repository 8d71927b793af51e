"""`gymtorch` equivalent: tensor interop of the facade's state handles.

Port of test_isaacgym_tpu/gymtorch.py. The reference bridges its CUDA sim
buffers to torch by wrapping their pointers (the reference's
examples/interop_torch.py:131-149). Here an acquire_* handle already holds a
tensor on the sim's device, allocated once: `wrap_tensor` returns that very
tensor, refresh_* writes into it in place, and set_* calls take a tensor on
the device as it is. The JAX package wraps a host numpy mirror instead.
"""
from __future__ import annotations

import numpy as np
import torch


def wrap_tensor(handle):
    """acquire_* handle -> the handle's own tensor (same storage, so its
    data_ptr() stays put across refreshes)."""
    if hasattr(handle, "buf"):
        return handle.buf
    return torch.as_tensor(handle)


def unwrap_tensor(tensor):
    """torch tensor -> the same tensor, on its device (no host copy); other
    array-likes -> numpy, which the set_* calls accept too."""
    if isinstance(tensor, torch.Tensor):
        return tensor
    return np.asarray(tensor)

"""Port parity: torch_utils (the isaacgym.torch_utils helpers) against the JAX
package's module called on the same torch CPU tensors (its torch branch).

Each of the module's functions on seeded inputs, within 1e-6; `to_torch`
honours its `device` (the JAX module's ignores it) and defaults to cuda:0.
"""
import inspect

import numpy as np
import pytest
import torch

import test_isaacgym_tpu  # noqa: F401  (CPU platform before jax init)
from test_isaacgym_tpu import torch_utils as jtu
from test_isaacgym_tpu_torch import torch_utils as ttu

RNG = np.random.RandomState(11)


def _t(*shape):
    return torch.as_tensor(RNG.uniform(-1, 1, shape).astype(np.float32))


def _q(n):
    q = _t(n, 4)
    return q / q.norm(dim=-1, keepdim=True)


Q, R, V, A = _q(16), _q(16), _t(16, 3), _t(16)
CASES = {
    "normalize": lambda m: m.normalize(V),
    "quat_unit": lambda m: m.quat_unit(Q * 3.0),
    "quat_mul": lambda m: m.quat_mul(Q, R),
    "quat_conjugate": lambda m: m.quat_conjugate(Q),
    "quat_apply": lambda m: m.quat_apply(Q, V),
    "quat_rotate": lambda m: m.quat_rotate(Q, V),
    "quat_rotate_inverse": lambda m: m.quat_rotate_inverse(Q, V),
    "quat_from_angle_axis": lambda m: m.quat_from_angle_axis(A * 3.0, V),
    "quat_to_angle_axis": lambda m: torch.cat([m.quat_to_angle_axis(Q)[0][:, None],
                                               m.quat_to_angle_axis(Q)[1]], -1),
    "get_euler_xyz": lambda m: torch.stack(m.get_euler_xyz(Q), -1),
    "quat_from_euler_xyz": lambda m: m.quat_from_euler_xyz(A, A * 0.5, -A),
    "orientation_error": lambda m: m.orientation_error(Q, R),
    "tensor_clamp": lambda m: m.tensor_clamp(V, -0.5 * torch.ones(3), 0.25 * torch.ones(3)),
    "get_axis_params": lambda m: torch.as_tensor(np.array(
        m.get_axis_params(0.7, 2) + m.get_axis_params(1.5, 0, y=0.3))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax_module(name):
    got, want = CASES[name](ttu), CASES[name](jtu)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_to_torch_honours_device_and_defaults_to_cuda():
    x = [[1.0, 2.0], [3.0, 4.5]]
    got, want = ttu.to_torch(x, device="cpu"), jtu.to_torch(x)
    assert got.dtype == want.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    g = ttu.to_torch(np.arange(3), dtype=torch.int64, device="cpu", requires_grad=False)
    assert g.dtype == torch.int64 and not g.requires_grad
    assert ttu.to_torch([1.0], device="cpu", requires_grad=True).requires_grad
    assert inspect.signature(ttu.to_torch).parameters["device"].default == "cuda:0"

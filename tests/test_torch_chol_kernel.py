"""csrc/chol.cu, the batched SPD solve, against its plain version.

The CPU tests hold the routing: CPU tensors take `_spd_solve` and never
build or load the kernel, and the wrapper refuses what the kernel does not
take before any library is loaded. The `cuda` tests, which run only where a
CUDA device is (`python -m pytest -q -m cuda tests/test_torch_chol_kernel.py`),
hold the kernel bit for bit to `_spd_solve` on the same CUDA tensors at the
cells' shapes and at the edges of what it takes, one launch a call. This
file imports no JAX: tests/test_torch_math.py holds the plain version to
the JAX package.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_isaacgym_tpu_torch.ops import _kernels
from test_isaacgym_tpu_torch.utils import linalg


def spd(shape, n, seed):
    """Random SPD float32 matrices (shape..., n, n): R R^T + n I."""
    r = np.random.RandomState(seed).normal(size=tuple(shape) + (n, n))
    a = r @ np.swapaxes(r, -1, -2) + n * np.eye(n)
    return torch.as_tensor(a.astype(np.float32))


def rhs(shape, seed):
    return torch.as_tensor(np.random.RandomState(seed).normal(size=shape).astype(np.float32))


def _refuse_loading(monkeypatch):
    fail = lambda *a, **k: pytest.fail("a library was built or loaded")  # noqa: E731
    monkeypatch.setattr(_kernels, "build", fail)
    monkeypatch.setattr(_kernels, "load", fail)


@pytest.mark.parametrize("n", [1, 3, 9, 24, 30])
def test_cpu_tensors_never_build_or_load_the_kernel(monkeypatch, n):
    """spd_solve, spd_inv and binv on CPU tensors take the plain version,
    build and load nothing, and leave the kernel's count as it was."""
    _refuse_loading(monkeypatch)
    monkeypatch.setattr(linalg, "_chol_cuda", lambda *a: pytest.fail("the kernel's wrapper ran"))
    before = dict(_kernels.launches)
    A, b = spd((5,), n, seed=n), rhs((5, n), seed=n + 1)
    x = linalg.spd_solve(A, b)
    np.testing.assert_allclose((A @ x[..., None])[..., 0].numpy(), b.numpy(), atol=1e-4)
    assert torch.equal(linalg.spd_inv(A), linalg.binv(A))
    assert dict(_kernels.launches) == before


def test_kernel_wrapper_refuses_cpu_tensors_before_loading(monkeypatch):
    """The wrapper's device and dtype check raises before any library is
    loaded: CPU tensors, float32 or float64, are refused by name."""
    _refuse_loading(monkeypatch)
    A, b = spd((4,), 3, seed=0), rhs((4, 3), seed=1)
    for args in ((A, b), (A.double(), b.double()), (A, None)):
        with pytest.raises(ValueError, match="one CUDA device"):
            linalg._chol_cuda(*args)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cuda(t):
    return t.to("cuda")


# case -> (A's batch shape, n, B's shape or None for spd_inv; "T" marks a B
# made transposed, as control's J^T is)
KERNEL_CASES = {
    "track_phase_a": ((4096, 1), 9, (4096, 1, 9)),  # physics/dynamics.py, a vector
    "control_mass_matrix": ((4096,), 7, ("T", 4096, 6, 7)),  # envs/franka.py, J^T
    "control_eef": ((4096,), 6, (4096, 6)),  # envs/franka.py, a vector
    "balls_phase_b": ((1, 1080), 3, (1, 1080, 3)),  # physics/step.py, a vector
    "soft_rail": ((1024, 1), 1, (1024, 1, 1)),  # one dof: n = 1
    "soft_inv": ((1024, 1), 1, None),  # phase C's spd_inv of the rail's operator
    "n2": ((257,), 2, (257, 2, 3)),
    "ant_n14_odd_batch": ((4097,), 14, (4097, 14)),  # a batch no multiple of a block's 4
    "n24": ((64,), 24, (64, 24, 5)),
    "k40": ((33,), 5, (33, 5, 40)),  # two chunks of 32 columns
    "broadcast_a": ((8, 1), 4, (8, 3, 4)),  # A's axis of 1 broadcast against B's 3
    "broadcast_b": ((), 4, (16, 4, 2)),  # one A against a batch of B
    "inv9": ((256,), 9, None),
    "inv24": ((64,), 24, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_equals_plain_bit_for_bit(case):
    """The kernel against _spd_solve on the same CUDA tensors, every output
    bit equal; exactly one launch a call."""
    _needs_cuda()
    lead, n, bshape = KERNEL_CASES[case]
    A = _cuda(spd(lead, n, seed=3))
    before = _kernels.launches["chol"]
    if bshape is None:
        got = linalg.spd_inv(A)
        eye = torch.zeros_like(A) + torch.eye(n, dtype=A.dtype, device=A.device)
        want = linalg._spd_solve(A, eye)
    else:
        if bshape[0] == "T":
            B = _cuda(rhs(bshape[1:], seed=4)).transpose(-1, -2)
            assert not B.is_contiguous()
        else:
            B = _cuda(rhs(bshape, seed=4))
        got = linalg.spd_solve(A, B)
        want = linalg._spd_solve(A, B)
    assert _kernels.launches["chol"] == before + 1
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_cuda
    assert torch.isfinite(want).all()
    diff = (got != want).sum().item()
    assert diff == 0, f"{case}: {diff} of {want.numel()} entries differ from the plain version"
    if bshape is None:
        assert torch.equal(linalg.binv(A), got)


@pytest.mark.cuda
def test_kernel_refuses_float64_and_grad():
    """A float64 input or one that requires grad raises on the card, with
    nothing launched: no caller differentiates a solve, and the kernel is f32."""
    _needs_cuda()
    A, b = _cuda(spd((64,), 9, seed=5)), _cuda(rhs((64, 9), seed=6))
    before = _kernels.launches["chol"]
    with pytest.raises(ValueError, match="float32"):
        linalg.spd_solve(A.double(), b.double())
    with pytest.raises(ValueError, match="float32"):
        linalg.spd_inv(A.double())
    with pytest.raises(ValueError, match="requires grad"):
        linalg.spd_solve(A, b.clone().requires_grad_(True))
    assert _kernels.launches["chol"] == before


@pytest.mark.cuda
def test_franka_step_launches_chol_four_times_sync_free():
    """A FrankaOscEnv step on the card runs with host syncs made errors and
    launches the kernel four times: phase A's solve in each of two substeps
    and the control's two."""
    _needs_cuda()
    from test_isaacgym_tpu_torch.envs.franka import FrankaOscEnv

    env = FrankaOscEnv(num_envs=64, device="cuda")
    one = env.rollout_fn(1)
    state = one(env.sim.state)  # warm: allocator, library and handles
    torch.cuda.synchronize()
    before = _kernels.launches["chol"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = one(state)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _kernels.launches["chol"] == before + 4
    assert torch.isfinite(state.dof_pos).all()

"""The launch contract of the port's hand-written kernels (ops/_kernels.py).

`inputs` is the one check of what a kernel takes: float32 tensors of exact
shapes on one CUDA device that do not require grad, returned contiguous.
On the CPU the refusals are held with fake CUDA tensors (FakeTensorMode: a
tensor's device, dtype and shape with no storage), so each case faults in
one way only, and none of them loads a library. The `cuda` tests, which run
only where a CUDA device is (`python -m pytest -q -m cuda
tests/test_torch_kernels.py` on the card), hold the copy of a
non-contiguous input and `launch`'s stream, error and count.
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from test_isaacgym_tpu_torch.ops import _kernels

CUDA0 = torch.device("cuda", 0)


def _fake_inputs(fault):
    """(dev, specs) of two inputs of shapes (4, 3) and (4,) on cuda:0, the
    second faulted by `fault`."""
    dev = CUDA0
    with FakeTensorMode():
        a = torch.empty(4, 3, device="cuda")
        b = torch.empty(4, device="cuda")
        if fault == "float64":
            b = b.double()
        elif fault == "wrong_shape":
            b = torch.empty(5, device="cuda")
        elif fault == "requires_grad":
            b = b.requires_grad_(True)
        elif fault == "two_devices":
            b = torch.empty(4, device="cuda:1")
    if fault == "cpu_input":
        b = torch.empty(4)
    elif fault == "cpu_device":
        dev, a, b = torch.device("cpu"), torch.empty(4, 3), torch.empty(4)
    return dev, (("a", a, (4, 3)), ("b", b, (4,)))


@pytest.mark.parametrize("fault,got", [
    ("float64", "torch.float64 (4,) on cuda:0"),
    ("cpu_input", "torch.float32 (4,) on cpu"),
    ("cpu_device", "a must be float32 (4, 3) on one CUDA device (cpu)"),
    ("wrong_shape", "torch.float32 (5,) on cuda:0"),
    ("requires_grad", "torch.float32 (4,) on cuda:0 that requires grad"),
    ("two_devices", "torch.float32 (4,) on cuda:1"),
])
def test_inputs_refuses_what_no_kernel_takes(monkeypatch, fault, got):
    """Each fault raises one ValueError, naming the input, what every kernel
    takes and what it got, before any library is loaded."""
    monkeypatch.setattr(_kernels, "load", lambda name: pytest.fail("a library was loaded"))
    dev, specs = _fake_inputs(fault)
    with pytest.raises(ValueError) as e:
        _kernels.inputs("probe", dev, specs)
    msg = str(e.value)
    assert msg.startswith("probe kernel: ")
    for part in ("float32", "one CUDA device", "requires grad", got):
        assert part in msg, (part, msg)


def test_inputs_returns_well_formed_inputs_as_they_are():
    """Contiguous float32 inputs of their shapes on the device come back
    themselves, in order."""
    dev, specs = _fake_inputs(None)
    got = _kernels.inputs("probe", dev, specs)
    assert len(got) == 2 and all(g is t for g, (_, t, _) in zip(got, specs))


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_inputs_copies_a_non_contiguous_cuda_input():
    """A transposed CUDA input is accepted and comes back as a contiguous
    copy of it; a contiguous one comes back itself."""
    _needs_cuda()
    a = torch.arange(12.0, device="cuda").reshape(3, 4).t()
    b = torch.zeros(4, device="cuda")
    got_a, got_b = _kernels.inputs("probe", a.device, (("a", a, (4, 3)), ("b", b, (4,))))
    assert not a.is_contiguous() and got_a.is_contiguous() and torch.equal(got_a, a)
    assert got_b is b


@pytest.mark.cuda
def test_launch_passes_the_stream_and_counts_only_a_success():
    """`launch` calls fn with the device's current stream last, counts
    `count` launches on a zero return, and raises on a nonzero one with
    nothing counted."""
    _needs_cuda()
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    seen = []
    before = _kernels.launches["probe"]
    _kernels.launch("probe", lambda *a: seen.append(a) or 0, dev, 1, 2.0, count=2)
    assert seen == [(1, 2.0, torch.cuda.current_stream(dev).cuda_stream)]
    assert _kernels.launches["probe"] == before + 2
    with pytest.raises(RuntimeError, match="probe kernel launch failed: CUDA error 700"):
        _kernels.launch("probe", lambda *a: 700, dev)
    assert _kernels.launches["probe"] == before + 2
    del _kernels.launches["probe"]

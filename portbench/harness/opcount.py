"""Operator counts: a frozen copy of chip_smoke.py's `count_ops`."""
from __future__ import annotations


def count_ops(fn) -> int:
    """PyTorch operators that fn() dispatches, views left out: in eager mode
    each is about one device launch made by the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.is_view
            return func(*args, **(kwargs or {}))

    with Count() as counter:
        fn()
    return counter.n

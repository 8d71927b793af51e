"""The lower-precision control: the reference in the precision below the
configuration's float32 with TF32 off, that is TF32: float32 whose matrix
products take their operands rounded to TF32's 10-bit mantissa, as the
tensor cores do (`mm`, on any device, with cuBLAS's TF32 on besides), and
every float input of a step rounded to TF32 (`round_tf32`), so that
arithmetic without products (the ball world's solve) computes from TF32
inputs too."""
from __future__ import annotations

import contextlib

import torch


def map_floats(fn, tree):
    """fn over every floating tensor of a tree of NamedTuples, tuples and
    lists; other leaves pass."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_floats(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_floats(fn, x) for x in tree)
    return tree


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10-bit mantissa, to nearest, ties
    to even; inf and nan pass."""
    if t.dtype != torch.float32:
        return t
    bits = t.view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + keep) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), rounded, t)


_TF32 = {"on": False}


def mm(a, b):
    """a @ b; inside `tf32_matmuls`, of a and b rounded to TF32."""
    if _TF32["on"]:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


@contextlib.contextmanager
def tf32_matmuls():
    """TF32 products inside the block (`mm`, and cuBLAS's); the settings
    restored after it."""
    old = torch.backends.cuda.matmul.allow_tf32, _TF32["on"]
    torch.backends.cuda.matmul.allow_tf32 = _TF32["on"] = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, _TF32["on"] = old


def control_step(step):
    """The reference's `step(state, dtype)` as the control steps: in
    float32 with TF32 matmuls, from its state's floats rounded to TF32."""
    def run(state):
        with tf32_matmuls():
            return step(map_floats(round_tf32, map_floats(lambda t: t.float(), state)),
                        torch.float32)
    return run

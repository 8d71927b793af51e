"""Debug mode.

Port of test_isaacgym_tpu/utils/debug.py. The reference has no sanitizers
at all: its tensor API's stale-view hazard is handled by call-ordering
convention alone. The checks here are of the hazards that exist in an eager
PyTorch step with in-place ops:

  * non-finite state escaping a substep (solver blow-up, bad asset mass),
  * a step writing through its input tensors (an in-place op on a tensor
    the caller still holds),
  * contact-table shape/dtype invariants drifting during a rewrite.

Enable with ``TIG_DEBUG=1`` in the environment. The per-substep finite
check is one reduction over the state's floating tensors and one host read
of its result, so it syncs with the device once per substep, and only
with the flag on; it raises FloatingPointError with the substep tag that
produced the first non-finite value.
"""
from __future__ import annotations

import os

import torch

__all__ = [
    "enabled",
    "check_finite",
    "assert_contact_tables",
    "verify_step_purity",
]


def enabled() -> bool:
    return os.environ.get("TIG_DEBUG", "0") not in ("", "0")


def _leaves(tree):
    """The tensors of a tensor, NamedTuple, tuple, list or dict, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return []


def check_finite(tree, tag: str):
    """Raise FloatingPointError if any floating tensor of `tree` holds a
    non-finite value; returns `tree`. One reduction on the device, then one
    host read."""
    leaves = [t for t in _leaves(tree) if t.is_floating_point()]
    if not leaves:
        return tree
    ok = torch.stack([torch.isfinite(t).all() for t in leaves]).all()
    if not bool(ok):
        raise FloatingPointError(f"TIG_DEBUG: non-finite simulation state after {tag}")
    return tree


def assert_contact_tables(point, normal, depth, num_envs, num_rows):
    """Shape and dtype invariants of the contact tables the solve reads."""
    assert point.shape == (num_envs, num_rows, 3), point.shape
    assert normal.shape == (num_envs, num_rows, 3), normal.shape
    assert depth.shape == (num_envs, num_rows), depth.shape
    assert depth.dtype == torch.float32, depth.dtype


def _same(a, b) -> bool:
    """Bitwise equality of two tensors, NaN equal to NaN."""
    if a is None or b is None:
        return a is b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def verify_step_purity(stepper, state, actions, params):
    """Aliasing check: a step must leave its input tensors bitwise
    unchanged, and a second step of the same input must give the same bits
    (every path of the step is deterministic, on the GPU too).

    PyTorch has no buffer donation, so the JAX package's donated-versus-kept
    comparison has no counterpart here: the re-run on the untouched input
    is what would diverge if the first step had written through it.

    Returns the stepped state. Raises AssertionError on any violation."""
    inputs = (state, actions, params)
    saved = [t.clone() for t in _leaves(inputs)]
    base = stepper.step(state, actions, params)
    for before, now in zip(saved, _leaves(inputs)):
        if not _same(before, now):
            raise AssertionError("TIG_DEBUG: the step wrote to its input tensors")
    again = stepper.step(state, actions, params)
    for a, b in zip(_leaves(base), _leaves(again)):
        if not _same(a, b):
            raise AssertionError("TIG_DEBUG: step not reproducible under purity check")
    return base

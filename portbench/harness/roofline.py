"""The least time of the sphere world's solve: a frozen copy of
chip_smoke.py's `sphere_world_bound`, its constants and the published
H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W)."""
from __future__ import annotations

import torch

PEAK_F32_OPS = 67e12  # f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
# f32 operations of one solve, per unit of work its data needs (sqrt and
# division count as one): the distance test of every candidate pair, once;
# the per-pair setup of each active pair (normal, material mix, effective
# masses, pre-solve normal velocity, target), once; the update of each
# active pair in each sweep (relative velocity, normal and friction
# impulses, both bodies' sums); each sphere's split update and ground
# contact in each sweep.
OPS_CANDIDATE, OPS_PAIR_SETUP, OPS_PAIR_SWEEP, OPS_BODY_SWEEP = 12, 60, 100, 80


def sphere_world_bound(args):
    """(least ms, "operations" or "bytes", active pairs) of one solve on
    these inputs: `args` as `ops/sphere_world.py::solve` takes them."""
    spec, pos, vel, omega, radius = args[:5]
    iters, contact_offset = args[10], args[11]
    N, F, _ = pos.shape
    allow = torch.as_tensor(spec.allow, device=pos.device)
    dist = torch.linalg.vector_norm(pos[:, :, None] - pos[:, None], dim=-1)
    depth = radius[:, :, None] + radius[:, None, :] - dist
    active = int((allow[None] & (depth > -contact_offset)).sum())
    candidates = N * int(spec.allow.sum())
    ops = (candidates * OPS_CANDIDATE + active * (OPS_PAIR_SETUP + iters * OPS_PAIR_SWEEP)
           + N * F * iters * OPS_BODY_SWEEP)
    n_in = sum(a.numel() for a in args[1:9])  # f32 inputs
    # + the allow mask's upper triangle as one bit a pair, as the kernel
    # reads it packed, + 3 f32 outputs
    nbytes = 4 * n_in + -(-(F * (F - 1) // 2) // 8) + 4 * 3 * (3 * N * F)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), active

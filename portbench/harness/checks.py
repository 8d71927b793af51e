"""The comparison with the reference that decides `correct`.

A field is compared unit by unit (its leading dim: an env, or a ball of
the sphere world) by |program - reference| / max(max |reference|, 1), the
repo's rule of the largest magnitude with the field's own scale; a unit's
gap is its worst field's.

`start_gap` is the worst unit of every episode start the program set up,
against the reference's own. `step_gap` is, over each kept step run by the
reference in float64 from the program's state before it, the worst unit's
gap between the program's state and outputs after it and the reference's,
leaving out the units whose answer the configuration's precision cannot
pin down: those where the reference itself moves by more than the limit
when the step's inputs are nudged by PERTURB_ULPS float32 ulp (twice, from
the seed), or when the reference runs in float32. A contact-rich step is
discontinuous (a contact row turning on, a grasp state switching), so in a
few units a rounding-level difference in the inputs gives another answer;
which units those are is the reference's finding alone, from the same
inputs. If more than MAX_SENSITIVE of the units are left out, the step
reads BAD. A number that is not finite reads BAD.
"""
from __future__ import annotations

import math

import torch

from . import trees

BAD = 1e30  # a non-finite or missing reading
PERTURB_ULPS = 1  # relative size of the nudge, in float32 ulps (2**-24 each)
MAX_SENSITIVE = 0.1


def unit_gaps(prog: dict, ref: dict) -> torch.Tensor:
    """(units,) float64: each unit's worst field gap; BAD where not finite."""
    worst = None
    for name, r in ref.items():
        p, r = prog[name].to(torch.float64), r.to(torch.float64)
        if p.shape != r.shape:
            raise ValueError(f"field {name}: program {tuple(p.shape)}, reference {tuple(r.shape)}")
        scale = max(float(r.abs().max()) if r.numel() else 0.0, 1.0)
        g = (p - r).abs().reshape(r.shape[0], -1).amax(1) / scale
        g = torch.where(torch.isfinite(g), g, torch.full_like(g, BAD))
        worst = g if worst is None else torch.maximum(worst, g)
    return worst


def field_gap(prog: dict, ref: dict) -> float:
    return float(unit_gaps(prog, ref).max())


def perturb(tree, generator):
    """The floating tensors of a tree, each value times (1 + d), d uniform
    within +-PERTURB_ULPS float32 ulps."""
    eps = PERTURB_ULPS * 2.0**-24

    def nudge(t):
        u = torch.rand(t.shape, generator=generator, device=t.device, dtype=torch.float64)
        return (t.to(torch.float64) * (1 + eps * (2 * u - 1))).to(t.dtype)

    return trees.tree_map(lambda t: nudge(t) if t.is_floating_point() else t, tree)


def step_gap(prog: dict, ref: dict, witnesses, limit: float):
    """(the step's gap, units left out, the median and the 99th percentile
    of all units' gaps): the gap is the worst unit's gap of prog against
    ref outside the units where a witness (the reference on nudged inputs,
    or in float32) parts from ref by more than `limit`."""
    gaps = unit_gaps(prog, ref)
    sensitive = torch.zeros_like(gaps, dtype=torch.bool)
    for w in witnesses:
        sensitive |= unit_gaps(w, ref) > limit
    left = int(sensitive.sum())
    q50, q99 = torch.quantile(gaps, torch.tensor([0.5, 0.99], dtype=gaps.dtype,
                                                 device=gaps.device)).tolist()
    if left > MAX_SENSITIVE * gaps.numel():
        return BAD, left, q50, q99
    kept = gaps[~sensitive]
    if not kept.numel():
        return 0.0, left, q50, q99
    return float(kept.max()), left, q50, q99


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        value = float(value) if math.isfinite(value) else BAD
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, out

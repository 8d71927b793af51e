"""The rest of a run, on the CPU at a tiny width with the look for a card
skipped, with the timed path broken underneath: `correct` comes out false
for each fault a cell can have."""
import pytest
import torch

from helpers import run, small_spec


def broken(make):
    """A patch that wraps the built cell's step with make(step)."""
    def patch(cell):
        cell.step = make(cell.step)
    return patch


def unchanged(step):
    """A step that returns its state unchanged."""
    def f(state):
        _, out = step(state)
        return state, out
    return f


def half_left_out(step):
    """A step that advances only the first half of the batch."""
    def pick(a, b):
        if isinstance(a, tuple):
            return type(a)(*[pick(x, y) for x, y in zip(a, b)])
        if not isinstance(a, torch.Tensor) or a.dim() == 0 or a.shape[0] < 2:
            return a
        h = a.shape[0] // 2
        return torch.cat([a[:h], b[h:]])

    def f(state):
        new, out = step(state)
        return pick(new, state), out
    return f


def altered(step):
    """A step whose answer for one env (the last) is altered where it is
    produced: its joint positions moved by 0.05 rad."""
    def f(state):
        new, out = step(state)
        q = new.dof_pos.clone()
        q[-1] += 0.05
        return new._replace(dof_pos=q), out
    return f


def moved_ball(step):
    """A step whose answer for one ball is altered: moved by 5 mm."""
    def f(state):
        new, out = step(state)
        p = new.root_pos.clone()
        p[0, -1, 2] += 5e-3
        return new._replace(root_pos=p), out
    return f


FAULTS = [
    ("franka-4096-track", unchanged), ("franka-4096-track", half_left_out),
    ("franka-4096-track", altered),
    ("balls-1080-pile", unchanged), ("balls-1080-pile", moved_ball),
]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_a_broken_step_is_not_correct(workload, fault):
    r = run(small_spec(workload), seconds=0.5, patch=broken(fault))
    assert not r["correct"], r["checks"]
    assert r["checks"]["step_gap"]["value"] > r["checks"]["step_gap"]["limit"]

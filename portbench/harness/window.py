"""The measured window.

After set-up the window steps the cell from its first episode start until
`seconds` have passed on the host clock (on several ranks: until the step
count that rank 0 then posts in a store), restarting at each episode
boundary from the next precomputed start, and ends in one synchronize. It
does no synchronize inside, except a traced run's, which ends its profiled
steps in one. On the card each step boundary records a CUDA event on the
step's stream; a step's time is the gap between consecutive events.

Some steps are kept for the comparison with the reference: the state a
step starts from, its outputs and the state it ends in are copied into
buffers allocated in set-up (a device copy, no sync), at step indices drawn
from the seed, and the last step's are kept by reference.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from . import trees

STOP_KEY = "portbench_stop"
STOP_MARGIN = 8  # steps past rank 0's stop: more than a rank's host can run ahead


class Stopper:
    """Whether the window is over after k steps."""

    def __init__(self, seconds, store=None, rank=0):
        self.seconds, self.store, self.rank = seconds, store, rank
        self.stop = None

    def done(self, k, elapsed) -> bool:
        if self.store is None:
            return elapsed >= self.seconds
        if self.stop is None:
            if self.rank == 0 and elapsed >= self.seconds:
                self.stop = k + STOP_MARGIN
                self.store.set(STOP_KEY, str(self.stop))
            elif self.rank != 0 and self.store.check([STOP_KEY]):
                self.stop = int(self.store.get(STOP_KEY))
        return self.stop is not None and k >= self.stop


@dataclasses.dataclass
class Result:
    steps: int
    wall_s: float
    step_ms: list
    samples: dict  # step index -> (state before, outputs, state after)
    episodes: int


class Profiled:
    """Steps [first, first + count) of the window under torch.profiler,
    inside one WINDOW_SPAN ending in a synchronize."""

    def __init__(self, first, count, on_cuda, flag):
        self.first, self.count, self.on_cuda, self.flag = first, count, on_cuda, flag
        self.prof = None
        self._span = None

    def begin(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import WINDOW_SPAN

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.flag["profiling"] = True

    def end(self):
        if self.on_cuda:
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.flag["profiling"] = False

    @property
    def active(self):
        return self.flag.get("profiling", False)


def run(cell, stopper, bufs, on_cuda, profiled=None) -> Result:
    """Step `cell` (a harness.cell.Cell) until `stopper` says stop; bufs[k]
    takes (before, outputs, after) of step k."""
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    starts, episode = cell.starts, cell.episode
    marks = []

    def mark():
        if on_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    sync()
    kept = {}
    state, k = starts[0], 0
    t0 = time.perf_counter()
    mark()
    while True:
        if episode and k and k % episode == 0:
            state = starts[(k // episode) % len(starts)]
        if profiled is not None and k == profiled.first:
            profiled.begin()
        before = state
        state, out = cell.step(state)
        if k in bufs:
            trees.copy_into(bufs[k], (before, out, state))
            kept[k] = bufs[k]
        if profiled is not None and k == profiled.first + profiled.count - 1:
            profiled.end()
        mark()
        k += 1
        if stopper.done(k, time.perf_counter() - t0) and not (profiled and profiled.active):
            break
    sync()
    wall = time.perf_counter() - t0
    kept[k - 1] = (before, out, state)
    if on_cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    episodes = 1 + (k - 1) // episode if episode else 1
    return Result(steps=k, wall_s=wall, step_ms=step_ms, samples=kept, episodes=episodes)

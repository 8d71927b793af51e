"""What a driver hands the harness: one side of a cell, the program (the
port), its reference, or the control."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class Cell:
    envs: int  # envs (worlds) this process steps in a step
    starts: list  # episode start states; episode e starts from starts[e % len]
    step: Callable  # state -> (state, outputs): the window's entry
    fields: Callable  # (state, outputs) -> {name: tensor} compared with the reference
    # state -> the state as the reference's step takes it (the program's
    # side: the part of its state that the step depends on)
    handoff: Callable = lambda state: state
    episode: Optional[int] = None  # steps an episode; None: one episode
    spans: list = dataclasses.field(default_factory=list)  # (owner, attribute, span name)
    counts: Optional[Callable] = None  # state -> {metric name: count}, outside the profile
    note: Optional[Callable] = None  # () -> lines printed after the window

"""The three sides a driver builds a cell on:

  * "program": the port, `test_isaacgym_tpu_torch`, as the configuration
    states it (float32, TF32 off);
  * "reference": the configuration's plain reference (portbench/reference/),
    in float64, each step from the state it is handed;
  * "control": the same reference in TF32 (reference/precision.py), put in
    the program's place: the lower-precision control.
"""
from __future__ import annotations

import importlib

from ..reference import precision

PORT = "test_isaacgym_tpu_torch"


def port(name: str):
    """The port's module `name`."""
    return importlib.import_module(f"{PORT}.{name}")


def reference_cell(cell, side: str):
    """A reference's cell as `side` ("reference" or "control") runs it: the
    control steps in TF32 from its starts rounded to TF32."""
    if side == "control":
        cell.starts = [precision.map_floats(lambda t: precision.round_tf32(t.float()), s)
                       for s in cell.starts]
        cell.step = precision.control_step(cell.step)
    elif side != "reference":
        raise ValueError(side)
    return cell


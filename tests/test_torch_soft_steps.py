"""Port parity: FEM soft bodies stepped against the JAX package.

The port's Simulator and the jitted JAX Simulator step the same scene
(envs/soft_body.py, the code-built icosphere stand-in), and soft_pos and the
rigid state are held at the goldens' rule, 1e-4 * max(|ref|, 1), every step
for as many steps as the JAX package's own jitted and op-by-op runs agree
(the horizons tests/test_torch_soft.py stores in soft_body_standin.npz and
soft_pedestals_standin.npz when run as a script):
  * the drop of tests/test_soft.py's _make_sim (height 1.2, the rail's speed
    limit 0.5) of two envs of Young's 3e4 and 6e5, after which
    the stiffer ball stands taller (tests/test_soft.py::
    test_soft_stiffness_ordering);
  * the press of tests/test_soft.py::test_soft_press_squeezes (1 env,
    height 1.05), from the JAX state 10 steps into the press, the plate on
    the ball: the box collider moving;
  * the pedestals (a sphere, two capsules and a hull under three balls).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_contacts import rolled_scan  # noqa: E402
from test_torch_soft import (  # noqa: E402
    GOLDEN, PEDESTALS_GOLDEN, _port_state, _step_both, drop_kwargs, jax_drop, jax_pedestals,
    press_kwargs, press_start, sb)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_drop_steps_like_jax(golden):
    kw = drop_kwargs()
    jsim, sim = jax_drop(2, **kw), sb.soft_body_sim(2, device="cpu", **kw)
    with rolled_scan():
        js, s = _step_both(jsim, sim, jsim.state, sim.state, int(golden["drop_self_agree"]), "drop")
    # the ground pushes the balls out of it at once; the stiffer one keeps
    # more of its height (tests/test_soft.py::test_soft_stiffness_ordering)
    for st in (s.soft_pos.numpy(), np.asarray(js.soft_pos)):
        height = st[..., 1].max(-1) - st[..., 1].min(-1)
        assert height[1] > height[0] + float(golden["drop_height_gap"]) / 2, height


def test_press_steps_like_jax(golden):
    """From the JAX state with the plate pressing the ball."""
    jsim, sim = jax_drop(1, **press_kwargs()), sb.soft_body_sim(1, device="cpu", **press_kwargs())
    with rolled_scan():
        down, js = press_start(jsim)
        plate_bottom = float(js.body_pos[0, 1, 1]) + 1.0 - 0.25 - jsim.scene.soft.thickness
        assert np.asarray(js.soft_pos)[0, :, 1].max() > plate_bottom - 1e-3  # on the plate
        ta = sim.actions._replace(dof_pos_target=torch.full_like(sim.actions.dof_pos_target, -1.0))
        _step_both(jsim, sim, js, _port_state(js), int(golden["press_self_agree"]), "press",
                   actions=(down, ta))


def test_pedestals_step_like_jax():
    jsim, sim = jax_pedestals(), sb.pedestals_sim(device="cpu")
    g = np.load(PEDESTALS_GOLDEN)
    with rolled_scan():
        _step_both(jsim, sim, jsim.state, sim.state, int(g["self_agree"]), "pedestals")



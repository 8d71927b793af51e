"""TIG_DEBUG sanitizer mode of the port (utils/debug.py): the three tests
of tests/test_debug_mode.py on the port, and what is particular to an eager
step with in-place ops.

  * the flagship Franka OSC step (8 envs) and the contact-rich franka_cube
    step (4 envs, the narrowphase's table asserts on) under the flag pass
    `verify_step_purity`: the inputs come back bitwise unchanged and a
    second step of them gives the same bits;
  * the finite check fires on a poisoned tree, and a NaN planted in one
    env's root velocity makes the step raise FloatingPointError;
  * `verify_step_purity` passes on the balls world and catches a step that
    writes to its input.
"""
import pytest
import torch

from test_isaacgym_tpu_torch.core.state import SimState


@pytest.fixture()
def tig_debug(monkeypatch):
    monkeypatch.setenv("TIG_DEBUG", "1")
    from test_isaacgym_tpu_torch.utils import debug

    assert debug.enabled()
    yield debug


def test_flagship_step_under_debug(tig_debug):
    from test_isaacgym_tpu_torch.envs.franka import FrankaOscEnv

    env = FrankaOscEnv(num_envs=8, device="cpu")
    assert env.sim.stepper.debug
    st = tig_debug.verify_step_purity(
        env.sim.stepper, env.sim.state, env.sim.actions, env.sim.params
    )
    assert torch.isfinite(st.dof_pos).all()


def test_franka_cube_step_under_debug(tig_debug):
    from test_isaacgym_tpu_torch.envs.franka_cube import FrankaCubeEnv

    env = FrankaCubeEnv(num_envs=4, device="cpu")
    actions = env.control(env.init_state)[0]
    st = tig_debug.verify_step_purity(env.sim.stepper, env.sim.state, actions, env.sim.params)
    assert torch.isfinite(st.root_pos).all()


def test_finite_check_catches_nan(tig_debug):
    """The finite check must actually fire on a poisoned tree."""
    bad = {"x": torch.tensor([1.0, float("nan"), 3.0]), "n": torch.tensor([1, 2])}
    with pytest.raises(FloatingPointError, match="non-finite"):
        tig_debug.check_finite(bad, "poison")
    assert tig_debug.check_finite({"x": torch.ones(3)}, "clean")["x"].sum() == 3


def _balls():
    from test_isaacgym_tpu_torch.envs.balls import BallsEnv

    return BallsEnv(pyramids=3, device="cpu").sim


def test_nan_in_root_velocity_raises_from_the_step(tig_debug):
    sim = _balls()
    vel = sim.state.root_linvel.clone()
    vel[0, 5, 2] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite simulation state after substep 0"):
        sim.stepper.step(sim.state._replace(root_linvel=vel), sim.actions, sim.params)


def test_purity_on_balls_and_a_step_that_writes_its_input(tig_debug):
    sim = _balls()
    st = tig_debug.verify_step_purity(sim.stepper, sim.state, sim.actions, sim.params)
    assert torch.isfinite(st.root_pos).all()

    class Leaky:
        contact = sim.stepper.contact

        def step(self, state: SimState, actions, params):
            state.root_pos.add_(1.0)  # an in-place op on the caller's tensor
            return state

    with pytest.raises(AssertionError, match="wrote to its input"):
        tig_debug.verify_step_purity(Leaky(), sim.state, sim.actions, sim.params)

"""On the card (marked `cuda`; they skip without one): the balls cell's
window goes through the hand-written sphere-world kernel, two launches a
solve, and is correct; its TF32 control is not."""
import pytest

from helpers import small_spec
from portbench.harness import runner


def run_on(device, spec, impl="program"):
    import time

    t0 = time.perf_counter()
    lines = []
    r = runner.run_rank(spec, 2**31 + 11, 2.0, 0, device, lambda: time.perf_counter() - t0,
                        impl=impl, out=lines.append)
    return r, lines


@pytest.mark.cuda
def test_balls_window_launches_the_kernel_and_is_correct(card):
    from test_isaacgym_tpu_torch.ops import _kernels
    from test_isaacgym_tpu_torch.ops.sphere_world import LAUNCHES_PER_SOLVE

    spec = small_spec("balls-1080-pile", check_within=50)
    before = _kernels.launches.get("sphere_world", 0)
    r, _ = run_on(card, spec)
    steps = spec.traffic["warmup_steps"] + r["attempted"]
    assert _kernels.launches["sphere_world"] - before == steps * LAUNCHES_PER_SOLVE
    assert r["correct"], r["checks"]


@pytest.mark.cuda
def test_balls_control_on_the_card_is_not_correct(card):
    r, _ = run_on(card, small_spec("balls-1080-pile", check_within=50), impl="control")
    assert not r["correct"], r["checks"]

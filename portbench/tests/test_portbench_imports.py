"""Nothing that a cell's run loads is JAX or the JAX package. The port's
name begins with the JAX package's, so top-level names are compared whole;
and without a card the run fails and prints no result."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]

LOAD_CELL = """
import sys
sys.path.insert(0, {root!r})
import portbench.run
from portbench.harness import imports, ranks, runner, spec as specmod, trace, window
spec = specmod.load({workload!r})
driver = specmod.load_module(spec.driver_path, "portbench_drivers")
for m in spec.end_to_end + spec.per_layer:
    specmod.metric_reader(m["name"])
cfg = dict(spec.config, num_envs=2)
inputs = driver.inputs(cfg, spec.traffic, 1, "cpu")
driver.build(cfg, spec.traffic, inputs, "cpu")
driver.build(cfg, spec.traffic, inputs, "cpu", impl="control")
driver.reference(cfg, spec.traffic, inputs, "cpu")
found = imports.forbidden_loaded()
assert not found, found
assert "test_isaacgym_tpu_torch" in sys.modules
print("OK", len(sys.modules))
"""


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_loads_no_jax(workload):
    out = subprocess.run([sys.executable, "-c", LOAD_CELL.format(root=ROOT, workload=workload)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_names_are_compared_whole():
    from portbench.harness.imports import forbidden_loaded

    assert forbidden_loaded(["test_isaacgym_tpu_torch", "test_isaacgym_tpu_torch.envs",
                             "jaxtyping", "flaxen"]) == []
    assert forbidden_loaded(["test_isaacgym_tpu.envs", "jax", "jaxlib.xla_client", "flax"]) == [
        "flax", "jax", "jaxlib.xla_client", "test_isaacgym_tpu.envs"]


def test_run_without_a_card_fails_and_prints_no_result(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr

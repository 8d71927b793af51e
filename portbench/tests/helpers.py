"""Small runs of the harness on the CPU for the tests."""
from __future__ import annotations

import time

from portbench.harness import runner, spec as specmod


def small_spec(workload, envs=4, **traffic):
    """The cell's spec at `envs` envs, its kept steps within the first few."""
    s = specmod.load(workload)
    s.config["num_envs"] = envs
    s.traffic.update({"check_within": 4, "trace_steps": 2}, **traffic)
    return s


def run(spec, seconds=1.0, trace=0, impl="program", patch=None, seed=2**31 + 7):
    t0 = time.perf_counter()
    return runner.run_rank(spec, seed, seconds, trace, "cpu", lambda: time.perf_counter() - t0,
                           impl=impl, patch=patch, out=lambda line: None)

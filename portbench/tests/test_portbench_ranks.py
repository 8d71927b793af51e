"""The harness's path for a cell on several cards, on the CPU: a toy cell
on two gloo ranks, added as files to a copy of the benchmark, whose step
exchanges every rank's counters. Its ranks agree on the window's end
through the store, rank 0 reports the slowest window and the worst gap,
and with the exchange left out `correct` comes out false."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

DRIVER = '''"""A toy driver on several ranks: a counter per env that each step adds
its rank + 1 to, and the counters of every rank gathered to each."""
import datetime
import os

import torch
import torch.distributed as dist

from portbench.harness.cell import Cell


def inputs(cfg, traffic, seed, device, rank=0):
    return {"rank": rank}


def gather(x):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def build(cfg, traffic, inputs, device, impl="program", rank=0, world=1):
    if not dist.is_initialized():
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
    add = inputs["rank"] + 1

    def step(state):
        new = state + add
        return new, (cell.exchange(new),)

    cell = Cell(envs=cfg["num_envs"], starts=[torch.zeros(cfg["num_envs"], 1)], step=step,
                fields=lambda s, o: fields(s, o, world))
    cell.exchange = gather
    return cell


def fields(state, out, world):
    """Per env: its counter and, after a step, every rank's counter of it."""
    f = {"count": state}
    if out is not None:
        f["all"] = out[0].reshape(world, -1).T
    return f


def reference(cfg, traffic, inputs, device, rank=0, world=1):
    add = inputs["rank"] + 1

    def step(state, dtype=torch.float64):
        k = state.to(dtype) / add + 1  # the steps every rank has taken after this one
        return state.to(dtype) + add, (torch.cat([k * (r + 1) for r in range(world)]),)

    return Cell(envs=cfg["num_envs"], starts=[torch.zeros(cfg["num_envs"], 1)], step=step,
                fields=lambda s, o: fields(s, o, world))
'''


def worker(bench_file, fault):
    """One rank: runs the toy cell; rank 0 prints its result."""
    import time

    import torch

    from portbench.harness import ranks, runner, spec as specmod

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    spec = specmod.load("toy-2x4-count", pathlib.Path(bench_file))
    patch = None
    if fault == "no_exchange":
        def patch(cell):  # every rank's slot holds this rank's counters
            cell.exchange = lambda x: x.repeat(world, 1)
    t0 = time.perf_counter()
    r = runner.run_rank(spec, 99, 0.5, 0, "cpu", lambda: time.perf_counter() - t0, rank=rank,
                        world=world, store=ranks.store(rank, world), patch=patch,
                        out=lambda line: None)
    if rank == 0:
        print("RESULT " + json.dumps(r), flush=True)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    shutil.copy(pathlib.Path(ROOT) / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(pathlib.Path(ROOT) / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((tmp / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy-2x4", "source": "a test", "reduced": [], "why": "counters",
                         "file": "portbench/configs/toy-2x4.json"})
    b["workloads"].append({"name": "toy-2x4-count", "config": "toy-2x4", "traffic": "count2",
                           "chips": 2, "why": "exchanged counters"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    bp = tmp / "portbench"
    (bp / "configs" / "toy-2x4.json").write_text(json.dumps({"num_envs": 4}))
    (bp / "drivers" / "toy-2x4.py").write_text(DRIVER)
    (bp / "traffic" / "count2.json").write_text(json.dumps(
        {"warmup_steps": 1, "check_steps": 2, "check_within": 5, "trace_from": 1,
         "trace_steps": 2}))
    # above the witnesses' one-ulp nudge, below any miscount
    (bp / "limits" / "toy-2x4-count.json").write_text(json.dumps({"start_gap": 0.0,
                                                                  "step_gap": 1e-6}))
    return tmp / "BENCHMARK.json"


def run_ranks(bench_file, fault, world=2):
    from portbench.harness import ranks

    port, store_port = ranks.free_port(), ranks.free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, **ranks.rank_env(r, world, port, store_port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([ROOT, os.path.dirname(os.path.abspath(__file__))]))
        procs.append(subprocess.Popen([sys.executable, __file__, str(bench_file), fault], env=env,
                                      stdout=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        outs.append(p.communicate(timeout=300)[0])
        assert p.returncode == 0
    line = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


def test_two_ranks_agree_and_report_the_slowest_window(bench):
    r = run_ranks(bench, "none")
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 2 and r["attempted"] >= 2
    assert set(r["metrics"]) >= {"env_steps_per_s", "setup_s"}


def test_the_exchange_left_out_is_not_correct(bench):
    r = run_ranks(bench, "no_exchange")
    assert not r["correct"] and r["checks"]["step_gap"]["value"] > 0


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])

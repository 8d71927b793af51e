"""One run of one cell on one rank: set-up, the window, the metrics, the
comparison with the reference, and (on rank 0) the result.

Set-up builds the driver's cell from inputs made from the seed, warms up
its shapes for the traffic's `warmup_steps` from its first start, and
allocates the buffers of the kept steps. The window follows (window.py).
After it, with the peak memory read, a traced run reduces its trace and
reads its counts; the program's outputs that are compared are taken and the
program is freed; then the driver's reference, built from the same inputs,
holds them (checks.py). On several ranks every number goes to rank 0, which
reports the slowest window, the mean of the per-layer readings and the
worst gap.
"""
from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np
import torch

from . import checks, spec as specmod, trace as tracemod, trees, window


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sample_steps(seed: int, traffic: dict):
    """The kept steps: `check_steps` indices drawn from the seed in
    [1, check_within); the window's last step is kept besides."""
    rng = np.random.default_rng(seed % 2**63)
    picks = rng.choice(np.arange(1, traffic["check_within"]), size=traffic["check_steps"],
                       replace=False)
    return sorted(int(k) for k in picks)


def wrap_spans(cell, flag, captured):
    """Each (owner, attribute, span[, capture]) of the cell's spans runs in
    a record_function span; with capture, the call's arguments are kept
    while the profile runs."""
    from torch.profiler import record_function

    for owner, attr, name, *capture in cell.spans:
        fn = getattr(owner, attr)
        keep = captured.setdefault(name, []) if capture and capture[0] else None

        def wrapped(*a, _fn=fn, _name=name, _keep=keep, **k):
            if _keep is not None and flag["profiling"]:
                _keep.append(a)
            with record_function(_name):
                return _fn(*a, **k)

        setattr(owner, attr, wrapped)


class Context:
    """What the metric readers (metrics/<name>.py) read."""

    def __init__(self, **kw):
        self.setup_s = None
        self.window = None  # window.Result of this rank
        self.windows = []  # (envs, steps, wall_s) of every rank
        self.envs = 0
        self.trace = None  # trace.Trace of a traced run
        self.profiled_steps = 0
        self.counts = {}
        self.captured = {}
        self.__dict__.update(kw)


def _gather(obj, world):
    if world == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def compare(driver, spec, inputs, prog_starts, kept, seed, device, rank, world):
    """({"start_gap", "step_gap"}, the count of starts and kept steps over
    their limits): the driver's reference, built from the same inputs,
    against the program's episode starts, and, from the state each kept
    step started from as the program handed it off, against the step
    (checks.py)."""
    t = time.perf_counter()
    ref = driver.reference(spec.config, spec.traffic, inputs, device, rank=rank, world=world)
    limits = spec.limits
    start_gaps = [checks.field_gap(p, ref.fields(r, None)) for p, r in zip(prog_starts, ref.starts)]
    step_gaps, spread = {}, {}
    for k, (before, prog) in sorted(kept.items()):
        want = ref.fields(*ref.step(before))
        g = torch.Generator(device=device)
        g.manual_seed((seed * 1000003 + k) % 2**63)
        witnesses = [ref.fields(*ref.step(checks.perturb(before, g))) for _ in range(2)]
        witnesses.append(ref.fields(*ref.step(before, torch.float32)))
        step_gaps[k], *spread[k] = checks.step_gap(prog, want, witnesses, limits["step_gap"])
    log(f"rank {rank}: reference: {len(start_gaps)} starts, steps {sorted(step_gaps)} in "
        f"{time.perf_counter() - t:.3f} s; start gaps {start_gaps}; step gaps {step_gaps}; "
        f"(units left out, median and 99th percentile unit gap) {spread} of "
        f"{next(iter(want.values())).shape[0]} units")
    failed = (sum(g > limits["start_gap"] for g in start_gaps)
              + sum(g > limits["step_gap"] for g in step_gaps.values()))
    return {"start_gap": max(start_gaps), "step_gap": max(step_gaps.values())}, int(failed)


def run_rank(spec, seed, seconds, trace, device, t_start, rank=0, world=1, impl="program",
             patch=None, store=None, out=print):
    """Run the cell of `spec` once; on rank 0 returns the result dict and
    prints earlier lines with `out`. `impl` "control" runs the reference in
    TF32 in the program's place; `patch(cell)` may alter the built cell (the
    tests' planted faults)."""
    on_cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # the configuration's float32
    torch.backends.cudnn.allow_tf32 = False
    driver = specmod.load_module(spec.driver_path, "portbench_drivers")
    cfg, tr = spec.config, spec.traffic
    inputs = driver.inputs(cfg, tr, seed, device, rank)
    cell = driver.build(cfg, tr, inputs, device, impl=impl, rank=rank, world=world)
    if patch is not None:
        patch(cell)
    flag, captured = {"profiling": False}, {}
    if trace:
        wrap_spans(cell, flag, captured)
    state = cell.starts[0]
    for _ in range(tr["warmup_steps"]):
        state, outputs = cell.step(state)
    bufs = {k: trees.tree_map(torch.empty_like, (cell.starts[0], outputs, state))
            for k in sample_steps(seed, tr)}
    del state, outputs
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = t_start()

    profiled = (window.Profiled(tr["trace_from"], tr["trace_steps"], on_cuda, flag)
                if trace else None)
    res = window.run(cell, window.Stopper(seconds, store, rank), bufs, on_cuda, profiled)
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    q = np.percentile(res.step_ms, [0, 25, 50, 75, 90, 99, 100]) if res.step_ms else []
    log(f"rank {rank}: window {res.steps} steps of {cell.envs} envs in {res.wall_s:.6f} s, "
        f"{res.episodes} episodes; set-up {setup_s:.6f} s; step ms min/25/50/75/90/99/max "
        f"{[round(float(x), 4) for x in q]}")
    if rank == 0:
        out(f"peak device memory: {peak} bytes (max_memory_allocated)")
        for line in cell.note() if cell.note else ():
            out(line)

    ctx = Context(setup_s=setup_s, window=res, envs=cell.envs, captured=captured)
    if trace:
        last = res.samples[res.steps - 1][2]
        ctx.counts = cell.counts(last) if cell.counts else {}
        path = tracemod.export(profiled.prof, f"rank{rank}")
        size = os.path.getsize(path)
        ctx.trace = tracemod.Trace.from_file(path)
        os.unlink(path)
        profiled.prof = None
        ctx.profiled_steps = tr["trace_steps"]
        log(f"rank {rank}: chrome trace of {tr['trace_steps']} steps: {size} bytes, "
            f"{len(ctx.trace.device)} device operations")
    layer = {}
    if trace:
        for m in spec.per_layer:
            v = specmod.metric_reader(m["name"], spec.root)(ctx)
            if v is not None:
                layer[m["name"]] = float(v)
        layer["busy_s"] = ctx.trace.busy_us() * 1e-6
        layer["window_s"] = ctx.trace.window_us * 1e-6

    # the comparison: the program's side first, then the program is freed
    prog_starts = [cell.fields(s, None) for s in cell.starts[:res.episodes]]
    kept = {k: (cell.handoff(b), cell.fields(a, o)) for k, (b, o, a) in res.samples.items()}
    breakdown = ctx.trace.breakdown() if trace else None
    ctx.trace = ctx.captured = None
    del cell, bufs, res.samples, profiled
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    numbers, failed = compare(driver, spec, inputs, prog_starts, kept, seed, device, rank, world)

    everyone = _gather({"win": (ctx.envs, res.steps, res.wall_s), "layer": layer,
                        "numbers": numbers, "failed": int(failed), "peak": peak}, world)
    if rank != 0:
        return None
    ctx.windows = [e["win"] for e in everyone]
    numbers = {k: max(e["numbers"][k] for e in everyone) for k in numbers}
    correct, compared = checks.verdict(numbers, spec.limits)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        if trace:
            vals = [e["layer"][m["name"]] for e in everyone if m["name"] in e["layer"]]
            v = sum(vals) / len(vals) if vals else None
        else:
            v = specmod.metric_reader(m["name"], spec.root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_cuda else "cpu",
        "kind": torch.cuda.get_device_name() if on_cuda else "cpu",
        "count": world,
        "memory_peak_bytes": max(e["peak"] for e in everyone),
    }
    if trace:
        for key in ("busy_s", "window_s"):
            dev[key] = sum(e["layer"][key] for e in everyone) / world
    result = {"correct": bool(correct), "attempted": int(res.steps),
              "failed": int(sum(e["failed"] for e in everyone)), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    return result

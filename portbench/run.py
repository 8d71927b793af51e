#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is a `workloads` entry of
BENCHMARK.json; its files are found by name (portbench/harness/spec.py).
The run sets up the cell from the seed, measures it for `--seconds`
(`--trace 1`: its per-layer metrics, from a profile of a fixed count of
steps inside the window), compares what it produced with the plain
reference, and prints one JSON line last on standard output; the numbers
compared, each beside its limit, are the last lines on standard error.

It fails, printing no result, without as many CUDA cards as the cell asks
for, and if JAX or the JAX package is loaded once the window has closed.
Build and kernel caches go to fixed directories under build/ in the
checkout. A cell on several cards runs a process a card; this one is rank
0 and prints the result.
"""
import os
import time


def _process_seconds():
    """Seconds since this process started (Linux's /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - ticks / os.sysconf("SC_CLK_TCK")


_T0 = time.perf_counter() - _process_seconds()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = {
    "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton"),
    "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions"),
    "CUDA_CACHE_PATH": os.path.join(ROOT, "build", "cuda_cache"),
}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # "control": the reference in TF32 in the program's place (the
    # lower-precision control; not a run the benchmark makes)
    ap.add_argument("--impl", choices=("program", "control"), default="program")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    os.environ.update(CACHES)
    sys.path.insert(0, ROOT)
    from portbench.harness import imports, ranks, runner, spec as specmod

    cell = specmod.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {count}",
              file=sys.stderr)
        return 3
    rank = int(os.environ.get("RANK", "0"))
    if cell.chips > 1:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))  # its inputs' card
    procs = []
    if cell.chips > 1 and "RANK" not in os.environ:
        procs = ranks.spawn([os.path.abspath(__file__), *(sys.argv[1:] if argv is None else argv)],
                            cell.chips)
    store = ranks.store(rank, cell.chips) if cell.chips > 1 else None
    try:
        result = runner.run_rank(
            cell, args.seed, args.seconds, args.trace, "cuda",
            lambda: time.perf_counter() - _T0, rank=rank, world=cell.chips, impl=args.impl,
            store=store, out=lambda line: print(line, flush=True))
    finally:
        codes = ranks.join(procs)
    if any(codes):
        print(f"portbench: ranks 1.. exited {codes}", file=sys.stderr)
        return 5
    found = imports.forbidden_loaded()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    if result is None:  # a rank other than 0
        return 0
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The ranks of a cell on several cards: one process a card, rank 0 the
process that prints the result. The spawn and its timeouts are copied from
tools/chip_phases.py's `spawn_ranks` and chip_smoke.py's `free_port`."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

RANK_TIMEOUT = 300  # seconds the other ranks may outlast rank 0's run
GROUP_TIMEOUT = 120  # seconds a collective or the store waits for a peer


def free_port() -> int:
    """A free TCP port on this host for a rendezvous."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_env(rank: int, world: int, port: int, store_port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "PORTBENCH_STORE_PORT": str(store_port)}


def spawn(argv, world: int):
    """Start ranks 1..world-1 as `python argv` with their rank's
    environment, their standard output sent to standard error; set rank
    0's environment in this process. Returns the processes."""
    port, store_port = free_port(), free_port()
    os.environ.update(rank_env(0, world, port, store_port))
    procs = []
    for r in range(1, world):
        env = dict(os.environ, **rank_env(r, world, port, store_port))
        procs.append(subprocess.Popen([sys.executable, "-u", *argv], env=env,
                                      stdout=sys.stderr, stderr=sys.stderr))
    return procs


def join(procs) -> list:
    """Wait for the ranks (RANK_TIMEOUT in all), kill any left, and return
    their exit codes."""
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def store(rank: int, world: int):
    """The TCPStore the ranks agree on the window's end through."""
    import datetime

    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", int(os.environ["PORTBENCH_STORE_PORT"]), world,
                         is_master=rank == 0,
                         timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))

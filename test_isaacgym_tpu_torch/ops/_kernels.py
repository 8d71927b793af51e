"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with ctypes. It is built at first
use into `build/torch_kernels/` at the repository root (git-ignored), under a
name keyed on the hash of its source and flags: a fresh checkout builds what
it runs, and an edited source rebuilds. Nothing here runs at import time.

A wrapper launches its kernel through `entry` (the ctypes function, its
types set once), `inputs` (the one check of what a kernel takes: float32
unless an input names its dtype, exact shapes, one CUDA device, no grad, as
no kernel has a backward; the tensors come back contiguous, for the caller
to keep alive until the launch is queued) and `launch` (the device made
current, as a library launches on the current one; its current stream
passed last; a nonzero return raised).
A kernel's own limits, its tables' device and its argument order stay in
its wrapper.

`launches` counts kernel launches by kernel name. `launch` adds to it right
after the launches it made succeeded, and nothing else does, so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# flags of one kernel beside NVCC_FLAGS: xpbd.cu, chol.cu and raycast.cu follow their
# plain versions' arithmetic operation by operation, so no multiply and add may be fused
KERNEL_FLAGS = {"xpbd": ("-fmad=false",), "chol": ("-fmad=false",),
                "raycast": ("-fmad=false",)}

launches: collections.Counter = collections.Counter()
build_logs: dict = {}  # kernel name -> nvcc/ptxas report of its last build
_libs: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            exe = os.path.join(CUDA_HOME, "bin", "nvcc")
    if exe is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return exe


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu unless a library of the same source and flags
    exists; returns the library's path."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + KERNEL_FLAGS.get(name, ())
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(src)],
            capture_output=True, text=True, check=False,
        )
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{build_logs[name]}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build(name)))
    return lib


def entry(kernel: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The ctypes function `symbol` of csrc/<kernel>.cu, its argument and
    result types set at its first use."""
    fn = getattr(load(kernel), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return fn


def inputs(kernel: str, dev: torch.device, specs) -> list:
    """The tensors of `specs`, (name, tensor, shape) triples, made contiguous;
    raises ValueError before any library is loaded on the first that is not
    float32 of that shape on `dev`, a CUDA device, or that requires grad. A
    spec (name, tensor, shape, dtype) asks for that dtype instead."""
    out = []
    for name, t, shape, *dtype in specs:
        shape, dtype = tuple(shape), (dtype or [torch.float32])[0]
        if (dev.type != "cuda" or t.device != dev or t.dtype != dtype
                or tuple(t.shape) != shape or t.requires_grad):
            raise ValueError(
                f"{kernel} kernel: {name} must be {str(dtype).removeprefix('torch.')} {shape} "
                f"on one CUDA device ({dev}) "
                f"and not a tensor that requires grad (the kernel has no backward); got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
                + (" that requires grad" if t.requires_grad else ""))
        out.append(t.contiguous())
    return out


def launch(kernel: str, fn, dev: torch.device, *args, count: int = 1) -> None:
    """fn(*args, stream) with `dev` the current device and its current
    stream's handle last; raises RuntimeError on a nonzero return, else
    adds `count` to launches[kernel]."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    launches[kernel] += count

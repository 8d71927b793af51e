"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with ctypes. It is built at first
use into `build/torch_kernels/` at the repository root (git-ignored), under a
name keyed on the hash of its source and flags: a fresh checkout builds what
it runs, and an edited source rebuilds. Nothing here runs at import time.

`launches` counts kernel launches by kernel name. Each wrapper adds to it
right after the launches it made succeeded, and nowhere else, so a run can
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

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# flags of one kernel beside NVCC_FLAGS: xpbd.cu follows the plain version's
# arithmetic operation by operation, so no multiply and add may be fused
KERNEL_FLAGS = {"xpbd": ("-fmad=false",)}

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

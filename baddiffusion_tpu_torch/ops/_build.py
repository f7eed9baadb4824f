"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``baddiffusion_tpu_torch/_build``
(git-ignored), named by a hash of the sources and flags so an edited source
is rebuilt and an unchanged one is reused. Only the sources in the package and
the CUDA toolkit are needed. Importing this module needs neither: nothing is
compiled until a kernel is first launched (or ``build`` is called).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
SOURCES = ("groupnorm_silu", "groupnorm_silu_bwd", "attention", "bias_shift", "vq_nearest")
# the kernels' dtype codes (csrc/common.cuh, ``bd::DType``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def current_stream(device: int) -> int:
    """The raw handle of CUDA device ``device``'s current stream, which an
    entry point launches into: each takes the device too and makes it
    current for its launches (csrc/common.cuh ``bd::DeviceGuard``), so a
    launch costs the host no device switch in Python and no ``Stream``
    object."""
    return torch._C._cuda_getCurrentRawStream(device)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libraries: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit to build")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))) + [os.path.join(CSRC_DIR, name + ".cu")]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns the wall time in seconds."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return time.perf_counter() - t0
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        build([name])
        lib = _libraries[name] = ctypes.CDLL(library_path(name))
    return lib

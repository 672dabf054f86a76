"""Build the port's CUDA kernels from the checkout's sources, and bind them.

Each kernel's ``.cu`` sources (under its ``csrc/``) compile with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The headers
shared by several kernels live in ``kernels/csrc/`` (on nvcc's include
path).  Libraries go to ``build/kernels/`` at the root of the checkout,
named by a hash of their sources, of every shared header and of the flags,
so a changed source or header rebuilds and an unchanged one is reused.
Nothing is built at import time: the first launch builds.

Each library exports ``<name>_launch`` (operand pointers, sizes, then the
stream; returns a CUDA error code) and ``<name>_error_string``.  ``load``
binds them, ``launch`` calls one on PyTorch's current stream and raises on
an error, ``check_operand`` is the wrappers' check of what a kernel takes, and
``sm_count`` the card's SMs that a launch plan fills.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
INCLUDE_DIR = Path(__file__).with_name("csrc")
# src/repro_torch/kernels/build.py -> the checkout's root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def build_library(name: str, sources):
    """Compile ``sources`` into ``lib<name>_<hash>.so`` unless it exists.
    Returns its path and nvcc's report (registers, spills; empty when the
    library was already there)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *sorted(INCLUDE_DIR.glob("*.cuh"))):
        digest.update(Path(src).read_bytes())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", tmp,
           *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


def load(name: str, sources, argtypes) -> ctypes.CDLL:
    """Build ``name`` from ``sources`` and load it; ``<name>_launch`` takes
    ``argtypes`` followed by the stream."""
    path, _ = build_library(name, sources)
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def launch(lib, name: str, device: torch.device, *args) -> None:
    """``<name>_launch(*args, stream)`` on the current stream of ``device``;
    raises if the launch failed."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(err)
                           .decode())


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (a launch plan's
    target)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_operand(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, the operands "
                         f"on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")

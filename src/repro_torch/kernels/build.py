"""Build the port's CUDA kernels from the checkout's sources.

Each kernel's ``.cu`` sources (under its ``csrc/``) compile with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go to
``build/kernels/`` at the root of the checkout, named by a hash of their
sources and flags, so a changed source rebuilds and an unchanged one is
reused.  Nothing is built at import time: the first launch builds.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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
    for src in sources:
        digest.update(Path(src).read_bytes())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr

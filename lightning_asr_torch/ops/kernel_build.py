"""Build the CUDA kernels in ``lightning_asr_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a plain C shared library, ``build/torch_kernels/<name>-<hash>.so`` under the
repository root, and loaded with ``ctypes``.  The hash covers the source, the
shared headers (``csrc/*.cuh``) and the compiler flags, so an edited source
is rebuilt and an unchanged one is reused.  All missing libraries are
compiled together, one ``nvcc`` process per source.

Nothing here runs at import time: the CPU tests import every module, and
this machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("mel", "lstm", "lstm_bwd", "lstm_bidir", "ctc", "extend", "sepconv", "depthwise")
# bytes of shared memory a Hopper block may use (dynamic, after opting in)
SMEM_LIMIT = 232448
# the ``dtype`` argument of the convolution kernels' C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):        # an edited header rebuilds its users
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{"seconds": wall time, "cached": True if nothing was built,
    "ptxas": {name: compiler report}}``; raises if a compile fails."""
    t0 = time.perf_counter()
    missing = [n for n in SOURCES if not library_path(n).exists()]
    reports = {}
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in missing:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu failed (rc {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, library_path(name))  # atomic if two processes build
        if failed:
            raise RuntimeError("\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "cached": not missing,
            "ptxas": reports}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            if not library_path(name).exists():
                build_all()
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return _LIBS[name]

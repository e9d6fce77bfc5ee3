"""Build and load the port's CUDA kernels.

Each source in ``transmogrifai_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  The build runs at first use, never at import, so the CPU tests
import every module without a CUDA toolkit.  All sources compile at once,
one ``nvcc`` process each.  A library's file name carries a hash of its
source and of the headers it includes, so an edited kernel rebuilds and an
unchanged one is reused.

``KernelError`` is the one exception of a kernel fault: a failed build, a
refused launch (every launch wrapper raises it with the CUDA error code), or
a Triton kernel that fails to compile or launch (``kernel_errors``).  The
validator lets it through where it records other failures of a candidate,
since no fallback hides a kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Sequence, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES: Tuple[str, ...] = ("bin_rows", "ensemble_walk", "level_hist", "split_scan",
                             "route_rows", "col_stats", "fista", "binary_metrics",
                             "regression_metrics", "multiclass_metrics", "weighted_gram",
                             "svc", "mlp", "naive_bayes", "threefry", "stream_stats",
                             "fused_layer", "sgns", "lda", "logistic_eval",
                             "predict_head")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")



class KernelError(RuntimeError):
    """A kernel of the port failed to build, compile or launch."""


@contextlib.contextmanager
def kernel_errors(name: str):
    """Raise any failure inside the block (a Triton kernel's compile or
    launch) as ``KernelError`` naming the kernel."""
    try:
        yield
    except KernelError:
        raise
    except Exception as e:
        raise KernelError(f"{name} kernel failed: {type(e).__name__}: {e}") from e


def check_launch(name: str, rc: int) -> None:
    """Raise ``KernelError`` unless a C entry point returned cudaSuccess."""
    if rc != 0:
        raise KernelError(f"{name} kernel launch failed: CUDA error {rc}")


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's report per source (ptxas registers / shared memory / spills)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels are built on a host "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return path


_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, the headers of
    ``csrc/`` that it includes (``#include "..."``) and the flags."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        text = fh.read()
    for header in _INCLUDE.findall(text):
        with open(os.path.join(CSRC, header.decode()), "rb") as fh:
            text += fh.read()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every named source that has no current library; returns the
    seconds spent.  Raises ``KernelError`` with nvcc's output if one fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs: List[Tuple[str, str, str, subprocess.Popen]] = []
    for name in names:
        target = _lib_path(name)
        if os.path.exists(target):
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, tmp, target, proc))
    failed = []
    for name, tmp, target, proc in jobs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, with each
    function's ``argtypes`` / ``restype`` declared from ``signatures``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
    return lib

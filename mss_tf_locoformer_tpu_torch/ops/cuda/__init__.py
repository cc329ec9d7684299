"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on its own by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds rather than the minutes a ``torch.utils.cpp_extension``
build takes.  Libraries go to ``build/torch_kernels/`` at the repository
root (git-ignored).  A library is built at its first use, and again when its
source is newer than it; ``build_all`` builds every one of them at once.
Processes that build at once (the ranks of a parallel run) take a file lock
per library, so one compiles and the others load its result.

Pointers and the CUDA stream cross ``ctypes`` as ``c_void_p``.  Every C entry
point returns ``cudaGetLastError()`` after its launches, and :func:`check`
raises when that is not 0: a launch the card refuses never runs, and no later
synchronisation would report it.

Nothing here is imported or built when the package is imported, and nothing
falls back: a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

__all__ = ["SOURCES", "BUILD_DIR", "SMEM_OPTIN", "load", "build_all", "check",
           "ptr", "stream_handle", "weight_splits", "wgrad_splits", "cached_panels"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = ("stft", "swiglu_block", "attention_block", "flash_attention",
           "swiglu_ffn", "dropout", "step_fp32", "ffn_core_fp32", "attn_fp32")
# Shared memory one block may opt into on an H100 (227 KB): the ceiling the
# step gates (``supports_step``, ``supports_block``) hold the layouts to.
SMEM_OPTIN = 232448
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}   # name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the library is newer than it (under
    a file lock, so that concurrent processes build it once)."""
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]

    def fresh():
        return (os.path.exists(lib)
                and os.path.getmtime(lib) >= max(map(os.path.getmtime, deps)))

    if fresh():
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".lib{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not fresh():
            _compile(name, src, lib)
    return lib


def _compile(name: str, src: str, lib: str) -> None:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{BUILD_LOG[name]}")
        os.replace(tmp, lib)   # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built if needed)."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_build(name))
        return _LIBS[name]


def build_all() -> float:
    """Build every kernel library in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build, SOURCES))
    for name in SOURCES:
        load(name)
    return time.perf_counter() - t0


def cached_panels(store, key: torch.Tensor, others, make):
    """The kernel layouts ``make()`` builds from the weights ``key`` and
    ``others``, kept in ``store`` (a ``WeakIdKeyDictionary``): a step's
    forward, its backward and a remat replay reuse one layout, and serving
    lays each step's weights out once.  An entry holds the weights weakly
    with their versions (an in-place update, as an optimizer step, bumps
    them), so a stale layout is never used."""
    ver = tuple(t._version for t in (key, *others))
    hit = store.get(key)
    if hit is not None and all(r() is o for r, o in zip(hit[0], others)) and hit[1] == ver:
        return hit[2]
    panels = make()
    store[key] = (tuple(weakref.ref(o) for o in others), ver, panels)
    return panels


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# The H100's SMs: the weight-gradient kernels' position splits fill them
# about four times over.
_SMS = 132


def weight_splits(blocks: int, units: int, least: int = 4) -> int:
    """Position splits of a weight-gradient kernel of ``blocks`` blocks a
    split: enough to fill the card's SMs about four times over, at least
    ``least`` units of positions (the kernel's step) per split."""
    return max(1, min(-(-4 * _SMS // blocks), units // least))


def wgrad_splits(m: int, taps: int, positions: int) -> int:
    """Position splits of a split-K weight-gradient product of ``csrc/
    wgrad.cuh`` (64-wide tiles of ``m`` per tap): :func:`weight_splits` with
    at least 4 chunks of 32 positions per split."""
    return weight_splits(-(-m // 64) * taps, positions // 32)

"""Build the hand-written CUDA kernels on first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C entry point (``<name>_launch``), loaded with
``ctypes``.  Libraries land in ``build/kernels/`` at the checkout's
root, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  ``build_all`` starts one
``nvcc`` per source, all at the same time.

Nothing here runs at import: the CPU tests import every module of the
port on a host with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_kv_write", "paged_attention", "paged_attention_varlen",
           "fused_logprob", "fused_logprob_bwd", "vtrace", "wkv6",
           "flash_attention", "ssm_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's diagnostics per source (ptxas register / shared-memory report).
build_log: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in parallel; returns the seconds
    each ``nvcc`` took (0.0 for a library already built)."""
    import time

    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {n: 0.0 for n in names}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


class Kernel:
    """One CUDA kernel: its lazily loaded C launcher and a launch count.

    ``argtypes`` lists the launcher's arguments; pointers and the stream
    are ``c_void_p`` so ctypes passes them at full width.  Calling the
    object launches the kernel on the given arguments, raises if the
    launcher returns a CUDA error, and only then adds one to
    ``launches`` (under a lock: a producer thread and the learner may
    launch one kernel at once).  :meth:`launch` does the same on a
    device's current stream (the calling thread's), which it appends as
    the last argument."""

    def __init__(self, name: str, argtypes) -> None:
        self.name = name
        self.launches = 0
        self._argtypes = list(argtypes)
        self._fn = None
        self._count_lock = threading.Lock()

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.name), f"{self.name}_launch")
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        check(self._fn(*args), self.name)
        with self._count_lock:
            self.launches += 1

    def launch(self, device, *args) -> None:
        """Launch on the current stream of CUDA ``device``, making it the
        current device only for the call and only when it is not
        already (a launch goes to the current device's context).  The
        stream is read as a raw handle: ``torch.cuda.current_stream()``
        builds a ``Stream`` object a call, which the launcher does not
        need."""
        index = device.index
        if torch.cuda.current_device() != index:
            with torch.cuda.device(index):
                self.launch(device, *args)
            return
        self(*args, torch._C._cuda_getCurrentRawStream(index))


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed, cudaError_t {err}"
            f" ({_CUDA_ERRORS.get(err, 'see cuda_runtime_api.h')})")


_CUDA_ERRORS = {
    1: "cudaErrorInvalidValue",
    2: "cudaErrorMemoryAllocation",
    9: "cudaErrorInvalidConfiguration",
    98: "cudaErrorInvalidDeviceFunction",
    209: "cudaErrorNoKernelImageForDevice",
}

"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Every source is compiled by ``nvcc`` for ``sm_90a`` at first use, one
``nvcc`` per source started together, and linked into one shared library
with a plain C interface that ``ctypes`` loads. The library lives under
``build/kernels/<hash of the sources>/`` at the repository root, so a checkout
builds it once and rebuilds only when a source changes. Each source's
``nvcc -Xptxas -v`` report (registers, shared memory, spills per kernel)
is kept beside the library as ``<source>.ptxas.log``.

Each kernel's Python wrapper owns a :class:`Kernel` record and calls its
``count(t)`` where it launches the kernel (and nowhere else), so a run can
show that its main path went through the kernels. Wrappers launch from any
thread (parallel/fanout.py runs fits concurrently, and PyTorch runs a CUDA
backward on its own autograd thread): ``count`` adds to the process total
``launches`` and to the tally of the stream the launch went to, under one
lock; a capture takes back exactly the launches on its own stream
(ops/kernels/__init__.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_NAME = "libmfvi_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of csrc/*.cu: name -> argtypes (every entry returns the
# launch's cudaError_t as an int)
_SIGNATURES = {
    "cf_conv_fwd": [_P] * 3 + [_I] * 9 + [_P],
    "cf_conv_dw": [_P] * 5 + [_I] * 9 + [_P],
    "radon_banded_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "radon_banded_adj": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fused_block_fwd": [_P] * 9 + [_I] * 7 + [_F] * 3 + [_P],
    "fused_block_bwd_dc": [_P] * 7 + [_I] * 8 + [_F] * 3 + [_P],
    "fused_block_bwd_dw": [_P] * 5 + [_I] * 9 + [_P],
    "fused_block_bwd_dx": [_P] * 3 + [_I] * 8 + [_P],
    "lrt_conv_fwd": [_P] * 5 + [_I] * 8 + [_P],
    "radon_dense_fwd": [_P] * 4 + [_I] * 4 + [_P],
    "radon_dense_adj": [_P] * 6 + [_I] * 7 + [_P],
}


COUNT_LOCK = threading.Lock()       # guards every count below
_BY_STREAM: dict = {}               # stream -> {kernel name: launches}


def stream_tally(stream: int) -> dict:
    """The launches counted on ``stream`` (a ``stream_of`` int) by kernel
    name, since the process started (only ever increased); read it under
    COUNT_LOCK."""
    return _BY_STREAM.setdefault(stream, {})


@dataclasses.dataclass
class Kernel:
    """One ported TPU kernel: its CUDA source, the Pallas kernel it replaces,
    and how many times its wrapper launched it, in all threads."""
    name: str
    source: str        # repository path of the CUDA source
    replaces: str      # file:line (function) of the Pallas TPU kernel
    launches: int = 0

    def count(self, t: torch.Tensor) -> None:
        """One launch of the kernel on the current stream of ``t``'s
        device."""
        stream = stream_of(t)
        with COUNT_LOCK:
            self.launches += 1
            tally = stream_tally(stream)
            tally[self.name] = tally.get(self.name, 0) + 1


_LOCK = threading.Lock()
_LIB = None
BUILD_SECONDS = 0.0


def _sources(suffixes=(".cu",)) -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(suffixes))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "the machine with the card (CUDA toolkit required)")


def _raise_on_failure(cmd: list, returncode: int, output: bytes) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           + output.decode(errors="replace"))


def _build(out_dir: str) -> None:
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(out_dir), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=os.path.dirname(out_dir))
    try:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            _raise_on_failure(cmd, proc.returncode, out)
            with open(obj[:-len(".o")] + ".ptxas.log", "wb") as f:
                f.write(out)
        lib = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
               *[obj for _, obj, _ in procs]]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        _raise_on_failure(cmd, link.returncode, link.stdout)
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not os.path.isfile(os.path.join(out_dir, LIB_NAME)):
                raise          # a concurrent build that won the race is fine
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call (thread-safe: one
    thread builds, the others wait)."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        h = hashlib.sha256()
        for src in _sources((".cu", ".cuh")):
            h.update(os.path.basename(src).encode())
            with open(src, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
        path = os.path.join(out_dir, LIB_NAME)
        t0 = time.perf_counter()
        if not os.path.isfile(path):
            _build(out_dir)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD_SECONDS = time.perf_counter() - t0
        _LIB = lib
        return lib


def ptxas_logs() -> dict:
    """{source file name: its ``nvcc -Xptxas -v`` report} of the built
    library."""
    lib_dir = os.path.dirname(library()._name)
    logs = {}
    for f in sorted(os.listdir(lib_dir)):
        if f.endswith(".ptxas.log"):
            with open(os.path.join(lib_dir, f)) as fh:
                logs[f[:-len(".ptxas.log")]] = fh.read()
    return logs


def stream_of_device(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` (of the calling thread), as a
    pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer-sized int."""
    return stream_of_device(t.device)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError "
                           f"{err}")


def require_cuda(t: torch.Tensor, what: str, dtypes=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {t.dtype} not in {dtypes}")

"""The port's one library of hand-written Hopper kernels: build, load, and
the helpers every wrapper shares.

Every kernel source in `bronko_tpu_torch/csrc/` (SOURCES) sits behind a
plain C interface. The first call on a CUDA tensor compiles each source
with nvcc for sm_90a into `csrc/build/`, all at once, links the objects
into one shared library (again whenever a source is newer than the
library) and loads it with ctypes. A failed build raises with nvcc's
output.

The wrappers live beside their plain PyTorch versions
(`ops/cuda_buckets.py`, `ops/count.py`, `ops/cuda_gather.py`,
`ops/cuda_map.py`). Each adds one to `LAUNCHES[name]` where it launches
its kernel, and nowhere else, so a run can show that its path went
through the kernels. Kernels launch from the engine's count workers and
its caller thread as well as its main thread, so the count goes through
`count_launch`, under a lock: `LAUNCHES[name] += 1` is a read,
an add and a write, and two threads can interleave them and lose one.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

__all__ = ["LAUNCHES", "LIB_PATH", "build", "library", "check_cuda", "check_k",
           "count_launch", "stream", "raise_on"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
SOURCES = tuple(os.path.join(CSRC_DIR, f) for f in (
    "bucket_kernels.cu", "count_kernels.cu", "gather_kernel.cu", "map_kernels.cu"))
LIB_PATH = os.path.join(BUILD_DIR, "libbronko_kernels.so")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC")

LAUNCHES = {"bucket_queries": 0, "fold_table": 0, "pack_windows": 0, "gather": 0,
            "probe_tally": 0, "walk_scatter": 0, "walk_hits": 0, "fastq_lines": 0,
            "fastq_pack": 0}

_lock = threading.Lock()
_launch_lock = threading.Lock()
_lib = None


def count_launch(name: str) -> None:
    """Add one to LAUNCHES[name]; safe from any thread."""
    with _launch_lock:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def _run(procs: list[subprocess.Popen]) -> str:
    """Wait for every nvcc process; raise with the first failure's output.
    Returns their reports (stderr) joined."""
    outs = [p.communicate()[1] for p in procs]
    for p, err in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:\n{err}")
    return "".join(outs)


def build() -> str | None:
    """Compile the kernels unless the library is newer than every source:
    one nvcc per source, all started together, then one link. Returns
    nvcc's report (ptxas register and shared-memory use) when it compiled,
    None when the library was up to date."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
            os.path.getmtime(s) for s in SOURCES):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in SOURCES]
    try:
        report = _run([subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                        stderr=subprocess.PIPE, text=True)
                       for s, o in zip(SOURCES, objs)])
        tmp = f"{LIB_PATH}.{tag}.tmp"
        _run([subprocess.Popen([nvcc, "-shared", "-o", tmp, *objs],
                               stderr=subprocess.PIPE, text=True)])
        os.replace(tmp, LIB_PATH)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return report


def library():
    """The loaded kernel library (built first if needed), with every entry
    point's C signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            signatures = {
                "bronko_bucket_queries": [i32, p, i64, i32, ctypes.c_uint32, i32, p, p, p, p],
                "bronko_fold_table": [i32, p, p, i64, i32, p, p],
                "bronko_pack_windows": [i32, p, p, i64, i64, i32, p, p, p],
                "bronko_fastq_lines": [i32, p, i64, p, p],
                "bronko_fastq_pack": [i32, p, i64, i32, p, p, p, p, p, p],
                "bronko_gather": [i32, p, i64, p, i64, p, p],
                "bronko_probe_tally": [i32, p, p, i64, i32, p, i64, p, i64, i64, i32, p, p,
                                       i32, i32, p, p, p, p, p],
                "bronko_probe_tally_words": [i32, p, p, i64, i32, p, i64, p, i64, i64, i32, p,
                                             p, i64, i32, p, p, p, p, p],
                "bronko_walk_scatter_words": [i32, p, i32, i32, p, p, p, i32, i64, p, p, i32,
                                              i64, p, i32, i64, p, i64, p],
                "bronko_walk_hits": [i32, p, p, i64, i32, p, i32, i64, i32, p, p],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.restype = i32
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def check_cuda(t: torch.Tensor, dtype: torch.dtype, name: str, dim: int = 1) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `dim`
    dimensions (the layout the kernels take)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} tensor, "
                         f"got {t.dtype} of shape {tuple(t.shape)}")


def check_k(k: int) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on t's device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")

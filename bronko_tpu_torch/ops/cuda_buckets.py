"""Hopper kernels K1 (bucket queries) and K2 (fold table): loader, wrappers
and their plain PyTorch versions.

Counterpart of `bronko_tpu/ops/pallas_buckets.py`. The kernels live in
`bronko_tpu_torch/csrc/bucket_kernels.cu` behind a plain C interface; the
first call on a CUDA tensor compiles them with nvcc for sm_90a into
`csrc/build/` (again whenever a source is newer than the library) and
loads the library with ctypes. A failed build raises with nvcc's output.

Dispatch follows the input's device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel. Nothing falls back from one to the
other. Each wrapper adds one to `LAUNCHES[name]` where it launches its
kernel, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from bronko_tpu_torch.ops.buckets import assign_buckets
from bronko_tpu_torch.ops.codec import canonical

__all__ = [
    "LAUNCHES", "build", "bucket_queries", "bucket_queries_plain",
    "fold_table", "fold_table_plain",
]

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
SOURCES = (os.path.join(CSRC_DIR, "bucket_kernels.cu"),)
LIB_PATH = os.path.join(BUILD_DIR, "libbronko_buckets.so")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-shared")

LAUNCHES = {"bucket_queries": 0, "fold_table": 0}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def build() -> str | None:
    """Compile the kernels unless the library is newer than every source.
    Returns nvcc's report (ptxas register and shared-memory use) when it
    compiled, None when the library was up to date."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
            os.path.getmtime(s) for s in SOURCES):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return proc.stderr


def _library():
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.bronko_bucket_queries.restype = i32
            lib.bronko_bucket_queries.argtypes = [
                i32, p, i64, i32, ctypes.c_uint32, i32, p, p, p, p]
            lib.bronko_fold_table.restype = i32
            lib.bronko_fold_table.argtypes = [i32, p, p, i64, i32, p, p]
            _lib = lib
    return _lib


def _check_cuda(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor, "
                         f"got {t.dtype} of shape {tuple(t.shape)}")


def _check_k(k: int) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# --- K1: canonical form + filtered bucket queries ---------------------------

def bucket_queries_plain(kmers: torch.Tensor, k: int, positions: tuple[int, ...]):
    """(B,) int64 k-mers -> (q (B, J) int64, canon (B,) int64, is_rc (B,) bool):
    q[:, j] is the bucket id at wildcard position positions[j] of the
    canonical k-mer, as the uint64 bit pattern."""
    canon, is_rc = canonical(kmers, k)
    q = assign_buckets(canon, k)[:, list(positions)]
    return q, canon, is_rc


def bucket_queries(kmers: torch.Tensor, k: int, positions: tuple[int, ...]):
    """K1. Same result as bucket_queries_plain; launches the kernel for a
    CUDA tensor. `positions` must be strictly increasing (the kernel takes
    them as a bit mask and writes them in position order)."""
    if kmers.device.type == "cpu":
        return bucket_queries_plain(kmers, k, positions)
    _check_cuda(kmers, torch.int64, "kmers")
    _check_k(k)
    if any(not 0 <= p < k for p in positions) or list(positions) != sorted(set(positions)):
        raise ValueError(f"positions must be strictly increasing in [0, {k}): {positions}")
    B, J = kmers.shape[0], len(positions)
    q = torch.empty((B, J), dtype=torch.int64, device=kmers.device)
    canon = torch.empty_like(kmers)
    is_rc = torch.empty(B, dtype=torch.bool, device=kmers.device)
    if B:
        keep = sum(1 << p for p in positions)
        err = _library().bronko_bucket_queries(
            kmers.device.index or 0, kmers.data_ptr(), B, k, keep, J,
            q.data_ptr(), canon.data_ptr(), is_rc.data_ptr(), _stream(kmers))
        _raise_on(err, "bucket_queries")
        LAUNCHES["bucket_queries"] += 1
    return q, canon, is_rc


# --- K2: pass-2 fold table ---------------------------------------------------

def fold_table_plain(kmers: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) int64 k-mers + (B,) int32 counts -> (B*k,) int32 records, k-mer
    major: canonical base i (bits 0-1), complement of canonical base k-1-i
    (bits 2-3), is_rc (bit 4), count (bits 5 and up) — as
    bronko_tpu.ops.map._fold_table."""
    canon, is_rc = canonical(kmers, k)
    shifts = 2 * torch.arange(k - 1, -1, -1, dtype=torch.int64, device=kmers.device)
    bases = (canon[:, None] >> shifts) & 3
    mirror = 3 - bases.flip(1)
    rec = (bases | (mirror << 2) | (is_rc.to(torch.int64) << 4)[:, None]
           | (counts.to(torch.int64) << 5)[:, None])
    return rec.to(torch.int32).reshape(-1)


def fold_table(kmers: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """K2. Same result as fold_table_plain; launches the kernel for CUDA
    tensors."""
    if kmers.device.type == "cpu":
        return fold_table_plain(kmers, counts, k)
    _check_cuda(kmers, torch.int64, "kmers")
    _check_cuda(counts, torch.int32, "counts")
    _check_k(k)
    if counts.shape != kmers.shape or counts.device != kmers.device:
        raise ValueError("kmers and counts must have the same shape and device")
    B = kmers.shape[0]
    out = torch.empty(B * k, dtype=torch.int32, device=kmers.device)
    if B:
        err = _library().bronko_fold_table(
            kmers.device.index or 0, kmers.data_ptr(), counts.data_ptr(), B, k,
            out.data_ptr(), _stream(kmers))
        _raise_on(err, "fold_table")
        LAUNCHES["fold_table"] += 1
    return out

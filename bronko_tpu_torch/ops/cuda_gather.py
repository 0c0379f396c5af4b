"""Hopper kernel K4 (`tbl[idx]`) of the gather probe, and its plain PyTorch
version.

Counterpart of `tests/profile_gather.py`, whose Pallas `pallas_gather`
gathers from a VMEM-resident table; `chip_smoke.py` runs the probe at its
shapes. The kernel lives in `csrc/gather_kernel.cu`, built and loaded
with the port's other kernels by `ops/cuda_lib.py`; `gather` adds one to
`cuda_lib.LAUNCHES["gather"]` where it launches it.
"""

from __future__ import annotations

import torch

from bronko_tpu_torch.ops.cuda_lib import check_cuda, count_launch, library, raise_on, stream

__all__ = ["gather", "gather_plain"]


def gather_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(U,) table, (N,) int32 indices in [0, U) -> (N,) tbl[idx]. Raises
    IndexError for an index outside [0, U) (torch would wrap a negative
    one)."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= tbl.shape[0]):
        raise IndexError(f"gather indices must lie in [0, {tbl.shape[0]})")
    return tbl[idx.long()]


def gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4. Same result as gather_plain for contiguous 1-D int32 CUDA
    tensors on one device, of any length and at any offset. Indices must
    lie in [0, U); the kernel does not check (that would cost a sync) and
    writes 0 for one outside."""
    if idx.device.type == "cpu":
        return gather_plain(tbl, idx)
    check_cuda(tbl, torch.int32, "tbl")
    check_cuda(idx, torch.int32, "idx")
    if tbl.device != idx.device:
        raise ValueError("tbl and idx must be on the same device")
    # the kernel's 16-byte body starts at idx's first 16-byte boundary:
    # out takes the same offset from one (idx may be a view that starts
    # between two; the allocator's blocks start on one)
    shift = (idx.data_ptr() % 16) // 4
    out = torch.empty(idx.numel() + shift, dtype=torch.int32, device=idx.device)[shift:]
    if idx.numel():
        err = library().bronko_gather(
            idx.device.index or 0, tbl.data_ptr(), tbl.shape[0], idx.data_ptr(),
            idx.numel(), out.data_ptr(), stream(idx))
        raise_on(err, "gather")
        count_launch("gather")
    return out

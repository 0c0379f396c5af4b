"""Memory telemetry: host RSS and the device's allocated bytes, logged at
stage boundaries (counterpart of `bronko_tpu/utils/memory.py`; the
reference logs physical RSS, util.rs:52-72). The device is named by the
caller: a CUDA device reports the caching allocator's live bytes, any
other reports none."""

from __future__ import annotations

import logging
import os

import torch

log = logging.getLogger("bronko")


def _host_rss_gb() -> float | None:
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    except Exception:  # noqa: BLE001 — no procfs
        return None


def _device_mem_gb(device: torch.device | None) -> float | None:
    if device is None or device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)["allocated_bytes.all.current"] / 1e9


def log_memory_usage(message: str, device: torch.device | None = None,
                     info: bool = True) -> None:
    """Log `<message> --- Memory usage: host X GB, device Y GB`."""
    host = _host_rss_gb()
    dev = _device_mem_gb(device)
    parts = []
    if host is not None:
        parts.append(f"host {host:.2f} GB")
    if dev is not None:
        parts.append(f"device {dev:.2f} GB")
    mem = ", ".join(parts) if parts else "unknown"
    (log.info if info else log.debug)("%s --- Memory usage: %s", message, mem)

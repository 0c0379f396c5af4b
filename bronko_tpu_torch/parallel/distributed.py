"""Multi-process execution over torch.distributed: one process a device.

Counterpart of `bronko_tpu/parallel/distributed.py`. JAX runs one process
a host, each holding many devices; the port runs one rank a device,
PyTorch's idiom. A rank's device is `cuda:<local rank>` (modulo the
host's card count), or the CPU under BRONKO_PLATFORM=cpu.

Ranks meet either through the three CLI flags (`--coordinator host:port
--num-processes N --process-id R`, a `tcp://` rendezvous) or through
torchrun's environment (`python -m torch.distributed.run`: RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT; `env://`). Before the process group
starts, every rank posts its host name and card count to the rendezvous
store, so each knows its local rank and how many ranks share its host.

The backend is NCCL when every rank has a card of its own on its host,
and gloo otherwise: on the CPU, or when several ranks share one card
(NCCL refuses two ranks on one GPU). Gloo then moves each collective's
CUDA tensor through host memory here, explicitly (`all_reduce`,
`all_to_all`); the mapping itself stays on the card. Collectives have a
finite timeout (DIST_TIMEOUT), so a rank that dies ends the run instead
of hanging it, and a collective that fails ends the run (exit 1) rather
than one sample.

File outputs are written by rank 0 alone (`is_primary`) unless each rank
owns its samples (`--shard-samples`); every rank holds the same merged
tallies and pileups, so this only keeps the same bytes from being written
twice.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from contextlib import contextmanager
from datetime import timedelta

import torch
import torch.distributed as dist

from bronko_tpu_torch.config import platform

log = logging.getLogger("bronko")

DIST_TIMEOUT = timedelta(minutes=10)

# (local rank, ranks on this host), set when this module starts a group
_local = (0, 1)
# host wall seconds this process has spent in its collectives, waiting
# for its peers included (under gloo a call blocks, and a CUDA
# tensor's copies through host memory count; under NCCL only the enqueue)
EXCHANGE_SECONDS = 0.0


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Start the process group. With the three arguments the ranks meet at
    tcp://coordinator; with none, only under torchrun's environment
    (WORLD_SIZE > 1 and MASTER_ADDR), through env://, and otherwise the run
    stays one process. Returns whether it started a group (not when one
    was running already)."""
    if dist.is_initialized():
        return False
    if coordinator is None and num_processes is None and process_id is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or not os.environ.get("MASTER_ADDR"):
            return False
        url, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        url, rank, world = f"tcp://{coordinator}", process_id, num_processes
    rank_device()  # no card for a rank: exit 1 before meeting the others
    store, rank, world = next(dist.rendezvous(url, rank=rank, world_size=world,
                                              timeout=DIST_TIMEOUT))
    _start(store, rank, world)
    return True


def init_world_of_one() -> None:
    """A process group of this process alone (`--mesh 1x1` without a
    launcher): the sharded path on a world of one."""
    rank_device()
    _start(dist.HashStore(), 0, 1)


def rank_device() -> torch.device:
    """This rank's device: the CPU under BRONKO_PLATFORM=cpu; under gpu
    (the default) the current CUDA device, which a rank of a group is set
    to when the group starts (its local rank modulo the host's cards).
    Exits 1 for another platform or when there is no CUDA device: the run
    never goes on on the CPU instead."""
    name = platform()
    if name == "cpu":
        return torch.device("cpu")
    if name != "gpu":
        log.error("BRONKO_PLATFORM=%s is not supported (use gpu or cpu)", name)
        raise SystemExit(1)
    if not torch.cuda.is_available():
        log.error("BRONKO_PLATFORM=gpu but no CUDA device is available; set "
                  "BRONKO_PLATFORM=cpu to run the plain PyTorch versions on the CPU")
        raise SystemExit(1)
    return torch.device("cuda", torch.cuda.current_device())


def _start(store, rank: int, world: int) -> None:
    """Post this rank's host and card count, place it among its host's
    ranks, pick the backend every rank agrees on, start the group."""
    global _local
    cards = torch.cuda.device_count() if platform() == "gpu" else 0
    store.set(f"bronko/host/{rank}", f"{cards}\t{socket.gethostname()}")
    keys = [f"bronko/host/{r}" for r in range(world)]
    store.wait(keys, DIST_TIMEOUT)
    hosts = [store.get(k).decode().split("\t", 1) for k in keys]
    mine = [r for r in range(world) if hosts[r][1] == hosts[rank][1]]
    _local = (mine.index(rank), len(mine))
    per_host: dict[str, tuple[int, int]] = {}
    for n, host in hosts:
        ranks, _ = per_host.get(host, (0, 0))
        per_host[host] = (ranks + 1, int(n))
    nccl = dist.is_nccl_available() and all(0 < ranks <= n for ranks, n in per_host.values())
    backend = "nccl" if nccl else "gloo"
    if cards:
        torch.cuda.set_device(_local[0] % cards)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=DIST_TIMEOUT)
    log.info("torch.distributed: rank %d of %d, local rank %d of %d on %s, backend %s%s",
             rank, world, _local[0], _local[1], hosts[rank][1], backend,
             "" if nccl or not cards else " (ranks share a card)")


def shutdown() -> None:
    """End the process group, if one was started."""
    global _local
    if dist.is_initialized():
        dist.destroy_process_group()
    _local = (0, 1)


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_world_size() -> int:
    """Ranks on this host (1 without a process group)."""
    return _local[1]


def is_primary() -> bool:
    """True on the rank that owns file outputs (always true alone)."""
    return world()[0] == 0


@contextmanager
def _collective():
    """Around one collective: its host wall seconds go to EXCHANGE_SECONDS,
    and a failure ends the run (exit 1), since the ranks' sequences of
    collectives would diverge."""
    global EXCHANGE_SECONDS
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:  # noqa: BLE001 — a peer died, timed out, or refused
        log.error("a collective failed: %s", e)
        raise SystemExit(1) from e
    finally:
        EXCHANGE_SECONDS += time.perf_counter() - t0


def all_reduce(t: torch.Tensor, op, group=None) -> None:
    """In-place all_reduce of `t` over `group` (default: the world). A CUDA
    tensor under gloo goes through host memory; an empty tensor is left
    as it is (every member of a group holds the same shape). A failure
    ends the run: the ranks' sequences of collectives would diverge."""
    if t.numel() == 0:
        return
    with _collective():
        if t.is_cuda and dist.get_backend(group) == "gloo":
            host = t.cpu()
            dist.all_reduce(host, op=op, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=group)


def all_to_all(t: torch.Tensor, in_splits: list[int], out_splits: list[int],
               group=None) -> torch.Tensor:
    """all_to_all_single over `group`: the first in_splits[r] rows of `t`
    (after those for the ranks before r) go to the group's rank r, and
    the rows received, out_splits[r] from rank r, come back in rank
    order. Split sizes are Python ints, each matching its peer's; every
    rank enters, an empty part too. A CUDA tensor under gloo goes through
    host memory; a failure ends the run, as all_reduce's does."""
    out = torch.empty((sum(out_splits), *t.shape[1:]), dtype=t.dtype, device=t.device)
    with _collective():
        if t.is_cuda and dist.get_backend(group) == "gloo":
            host = torch.empty(out.shape, dtype=t.dtype)
            dist.all_to_all_single(host, t.cpu(), out_splits, in_splits, group=group)
            out.copy_(host)
        else:
            dist.all_to_all_single(out, t.contiguous(), out_splits, in_splits, group=group)
    return out


def allgather_bytes(data: bytes) -> list[bytes]:
    """One byte payload from every rank, in rank order ([data] alone).
    The sample-sharded cohort gathers its results through it."""
    rank, size = world()
    if size == 1:
        return [data]
    out: list = [None] * size
    with _collective():
        dist.all_gather_object(out, data)
    return out

"""The ('data', 'genome') mesh of torch.distributed ranks.

Counterpart of `bronko_tpu/parallel/mesh.py`, with one rank a device. Rank
r of a DxG mesh sits at data row d = r // G and genome column g = r % G,
the row-major order of JAX's make_mesh (mesh.py:29):

  * 'genome': the G ranks of a data row (its genome group) hold the G
    shards of the index and probe the same k-mers; hit counts sum over
    this group before classification;
  * 'data': the D ranks of a genome column (its data group) hold the same
    shard and probe different k-mers; tallies sum over this group.

Pass 2 spreads over all D*G ranks; its pileup planes merge over the world.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch.distributed as dist

from bronko_tpu_torch.parallel.distributed import init_world_of_one, shutdown

log = logging.getLogger("bronko")


@dataclass
class Mesh:
    n_data: int
    n_genome: int
    rank: int
    d: int                # this rank's data row
    g: int                # this rank's genome column (its index shard)
    genome_group: object  # the ranks of row d
    data_group: object    # the ranks of column g
    owns_world: bool      # make_mesh started the (one-rank) world itself

    @property
    def size(self) -> int:
        return self.n_data * self.n_genome

    def close(self) -> None:
        """End the world of one that make_mesh started; a launched world
        stays for its launcher."""
        if self.owns_world:
            shutdown()


def make_mesh(n_data: int, n_genome: int) -> Mesh:
    """This rank's place in a DxG mesh, and its two groups. Every rank
    creates every group, in the same order (new_group is a collective).
    Exits 1 unless the world has exactly D*G ranks; a 1x1 mesh in a
    process without a group starts a world of one."""
    n = n_data * n_genome
    owns = False
    if not dist.is_initialized() and n == 1:
        init_world_of_one()
        owns = True
    size = dist.get_world_size() if dist.is_initialized() else 1
    if size != n:
        log.error("mesh %dx%d needs %d ranks, have %d: launch one process a device with "
                  "`python -m torch.distributed.run --nproc-per-node %d -m bronko_tpu_torch "
                  "call ...`, or start %d processes with --coordinator host:port "
                  "--num-processes %d --process-id 0..%d",
                  n_data, n_genome, n, size, n, n, n, n - 1)
        raise SystemExit(1)
    rank = dist.get_rank()
    d, g = divmod(rank, n_genome)
    rows = [dist.new_group([r * n_genome + c for c in range(n_genome)]) for r in range(n_data)]
    cols = [dist.new_group([r * n_genome + c for r in range(n_data)]) for c in range(n_genome)]
    return Mesh(n_data, n_genome, rank, d, g, rows[d], cols[g], owns)

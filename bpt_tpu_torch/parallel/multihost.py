"""Multi-host set-up for the row-tile renderer (port of
``bpt_tpu.parallel.multihost``).

Nothing of the math changes across hosts: the RNG is keyed by absolute
pixel coordinates, so a hosts x chips render equals the single-process one.
What changes is how the group is formed and who holds which rows:

* every process calls ``initialize`` first (one process a device, as
  ``torchrun --nproc-per-node N`` starts them: it sets ``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and
  ``LOCAL_WORLD_SIZE``);
* ``make_multihost_mesh`` builds the flat ``("tiles",)`` mesh over every
  rank, or a ``("hosts", "chips")`` grid whose flattened order keeps a
  host's rows contiguous;
* the entry points of ``bpt_tpu_torch.parallel.sharding`` run unchanged;
  each process computes and holds its own rows.

A host is ``LOCAL_WORLD_SIZE`` consecutive ranks (1 where it is not set).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from bpt_tpu_torch.device import default_device
from bpt_tpu_torch.parallel.sharding import make_mesh


def initialize(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
               device=None) -> None:
    """Join the process group (idempotent: a second call does nothing).

    ``device=None`` means the card, as every entry point of the port does:
    NCCL, each rank on card ``LOCAL_RANK`` mod the cards it sees, and a
    RuntimeError where torch sees none; ``device="cpu"`` means gloo.
    ``init_method`` defaults to ``env://`` (``torchrun``'s variables); with
    ``tcp://host:port`` pass ``world_size`` and ``rank``."""
    if dist.is_initialized():
        return
    dev = default_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)) % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size, rank=-1 if rank is None else rank)


def local_world_size() -> int:
    """Ranks per host: ``LOCAL_WORLD_SIZE``, else 1."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def make_multihost_mesh(axis: str = "tiles", hierarchical: bool = False, device_type: str | None = None
                        ) -> DeviceMesh:
    """The flat 1-D ``(axis,)`` mesh over every rank in rank order, or with
    ``hierarchical=True`` a ``("hosts", "chips")`` mesh of world /
    ``local_world_size()`` hosts, rank h·chips + c at (h, c)."""
    if not hierarchical:
        return make_mesh(device_type, axis)
    world, per_host = dist.get_world_size(), local_world_size()
    if world % per_host:
        raise ValueError(f"{world} ranks do not make hosts of {per_host}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // per_host, per_host), mesh_dim_names=("hosts", "chips"))


def host_row_range(height: int, mesh: DeviceMesh) -> tuple[int, int]:
    """[row0, row1) of the film that this process's host owns when its rows
    are split over the mesh's ranks in flattened order (the rows of the
    host's ranks, contiguous): for a host's input pipeline or its IO."""
    ranks = mesh.mesh.reshape(-1).tolist()
    n = len(ranks)
    if height % n:
        raise ValueError(f"height={height} must divide evenly over the {n} ranks of the mesh (as the sharded "
                         "renderer requires); a remainder would leave rows no host owns")
    rows = height // n
    host = dist.get_rank() // local_world_size()
    mine = [i for i, r in enumerate(ranks) if r // local_world_size() == host]
    return min(mine) * rows, (max(mine) + 1) * rows

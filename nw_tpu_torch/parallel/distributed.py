"""Multi-process initialization and sharded-batch helpers: the
counterpart of ``nw_tpu/parallel/distributed.py``.

Every rank calls :func:`init_distributed`, builds the same mesh
(:func:`~nw_tpu_torch.parallel.mesh.make_mesh`) and feeds its own shard
of the pair batch to
:func:`~nw_tpu_torch.parallel.data_parallel.align_batch_sharded`.

The backend is the caller's choice and is never switched behind its
back: ``"nccl"`` when every rank has a card of its own (the halos then
move card to card), ``"gloo"`` for CPU ranks and for ranks that share a
card (the kernels still run on the card; gloo carries the halos and
statistics through host memory).  NCCL refuses two ranks on one card,
so asking for it there raises here, before any communicator exists.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from nw_tpu_torch.parallel.mesh import axis_group


def init_distributed(
    backend: str,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_rank: Optional[int] = None,
    device: str = "cuda",
) -> bool:
    """Join the default process group from arguments or ``torchrun``'s
    variables.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to ``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``; ``local_rank`` (the card this rank
    drives) to ``LOCAL_RANK``, else ``process_id``.  With
    ``device="cuda"`` the rank's card is made current first: card
    ``local_rank`` under NCCL, which must exist (a card a rank), card
    ``local_rank % device_count`` under gloo.  Returns True when a
    process group was joined (or already was), False for a
    single-process run: no coordinator given and none in the
    environment.
    """
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        return False
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is available; pass device='cpu'")
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
        if backend == "nccl" and (local_rank >= cards or local_world > cards):
            raise ValueError(
                f"NCCL needs a card for each rank: local rank {local_rank} of "
                f"{local_world} with {cards} card(s); ranks that share a card use gloo"
            )
        torch.cuda.set_device(local_rank % cards)
        torch.cuda.init()
    elif backend == "nccl":
        raise ValueError("NCCL carries CUDA tensors only: CPU ranks use gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
    )
    return True


def coll_device(group) -> torch.device:
    """Where a collective's tensors must live: the rank's (current) card
    under NCCL, host memory under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_batch_from_local(mesh, axis: str, *local_arrays):
    """Each rank's own shard of a pair batch, checked: every rank of
    ``axis`` must hold shards of the same shapes (the batch divides
    evenly, as ``nw_tpu`` requires).  Returns the shards as they are;
    in the port a rank never holds another's pairs."""
    group = axis_group(mesh, axis)
    shapes = [tuple(a.shape) for a in local_arrays]
    gathered = [None] * dist.get_world_size(group)
    dist.all_gather_object(gathered, shapes, group=group)
    if any(g != shapes for g in gathered):
        raise ValueError(f"the ranks' shards differ in shape: {gathered}")
    return tuple(local_arrays)

"""Device-mesh helpers: the counterpart of ``nw_tpu/parallel/mesh.py``.

A JAX ``Mesh`` with named axes becomes a ``torch.distributed``
``DeviceMesh`` (``init_device_mesh``); a function of this package reads
the process group of its axis with ``mesh.get_group(axis)``.  Each rank
drives one device of its own, set by
:func:`~nw_tpu_torch.parallel.distributed.init_distributed` before the
mesh is made (a ``DeviceMesh`` then keeps it), so ranks that share one
card (gloo) are as welcome as ranks with a card each (NCCL).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``DeviceMesh`` over the ranks of the default process group.

    Default: every rank on one ``data`` axis.  ``shape=(d, s)`` with
    ``axis_names=("data", "seq")`` gives a 2-D mesh, as ``nw_tpu``'s.
    ``device_type`` is ``"cuda"`` or ``"cpu"`` (the tests' gloo ranks).
    Call :func:`~nw_tpu_torch.parallel.distributed.init_distributed`
    first.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call init_distributed first")
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(shape)
    if math.prod(shape) > world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks, have {world}")
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(shape)} axes need {len(shape)} names, not {list(axis_names)}")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis``: ``mesh`` is a
    ``DeviceMesh``, a ``ProcessGroup`` (its one axis) or None (the
    default group)."""
    if mesh is None:
        return dist.group.WORLD
    if isinstance(mesh, DeviceMesh):
        return mesh.get_group(axis)
    return mesh

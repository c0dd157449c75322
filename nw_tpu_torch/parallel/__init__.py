"""Multi-rank execution on ``torch.distributed``: the counterpart of
``nw_tpu/parallel/``.

* :mod:`~nw_tpu_torch.parallel.mesh` — :func:`make_mesh`, a named
  ``DeviceMesh`` over the ranks;
* :mod:`~nw_tpu_torch.parallel.distributed` — :func:`init_distributed`
  (arguments or the ``torchrun`` variables; the backend is the caller's
  choice) and :func:`global_batch_from_local`;
* :mod:`~nw_tpu_torch.parallel.data_parallel` — :func:`align_batch_sharded`:
  each rank fills its own shard of a pair batch, the run statistics merge
  with ``all_reduce`` (exact int64 sums);
* :mod:`~nw_tpu_torch.parallel.huge_pair` — BASELINE config 5: one pair
  too large for one device, its rows sharded over the ranks, filled as a
  pipelined wavefront of tiles (``nw_fill_tile``) with a chunked halo and
  walked by a relay from rank to rank;
* :mod:`~nw_tpu_torch.parallel.workers` — :class:`RankGroup`, ranks as
  child processes of one caller (the tests and ``chip_smoke.py``).

Every function that takes a ``mesh`` is collective: each rank of the
mesh's ``axis`` calls it with the same arguments.  ``mesh`` may also be
a plain ``ProcessGroup``, or None for the whole world.
"""

from nw_tpu_torch.parallel.data_parallel import align_batch_sharded, batch_stats, shard_batch
from nw_tpu_torch.parallel.distributed import global_batch_from_local, init_distributed
from nw_tpu_torch.parallel.huge_pair import (
    HugeShardedResult,
    auto_chunk,
    huge_pair_align_sharded,
    huge_pair_score_sharded,
    pipeline_efficiency,
)
from nw_tpu_torch.parallel.mesh import make_mesh

__all__ = [
    "HugeShardedResult", "align_batch_sharded", "auto_chunk", "batch_stats",
    "global_batch_from_local", "huge_pair_align_sharded", "huge_pair_score_sharded",
    "init_distributed", "make_mesh", "pipeline_efficiency", "shard_batch",
]

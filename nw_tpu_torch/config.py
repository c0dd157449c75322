"""Configuration dataclasses for the alignment engine.

Field-for-field mirror of ``nw_tpu/config.py``: :class:`ScoringParams`
holds the ``m k d`` operands (needleman-wunsch.c:654-689) and
:class:`AlignConfig` the batching / bucketing knobs.  Nothing here
depends on a framework, so a configuration built for ``nw_tpu`` crosses
over through :meth:`AlignConfig.from_dict` (``dataclasses.asdict``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ScoringParams:
    """Linear gap scoring: +m for match, -k for mismatch, -d per indel.

    Candidate scores are ``diag + m`` on character equality, ``diag - k``
    otherwise, and ``up - d`` / ``left - d`` for gaps
    (needleman-wunsch.c:430-437, :454).  Values may be negative.
    """

    match: int = 1
    mismatch: int = 1
    indel: int = 1

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.match, self.mismatch, self.indel)


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Engine configuration.

    Attributes:
      scoring: the ``m k d`` scoring operands.
      bucket_sizes: length buckets for batched alignment; each batch is
        padded to the smallest bucket that holds its longest sequence.
        ``None`` pads to the next multiple of 128.
      traceback, use_pallas, band, max_alignments, mesh_shape: carried
        so that an ``nw_tpu`` configuration round-trips; the batched
        path of this package does not read them.
    """

    scoring: ScoringParams = dataclasses.field(default_factory=ScoringParams)
    # ~1.2x steps: DP work scales with the product of the padded
    # lengths, so a dense ladder bounds the padding waste; beyond the
    # ladder lengths round up to the next KiB.
    bucket_sizes: Optional[Sequence[int]] = (
        64, 96, 128, 160, 192, 256, 320, 384, 512, 640, 768, 1024,
        1280, 1536, 2048, 2560, 3072, 4096, 5120, 6144, 8192,
    )
    traceback: bool = True
    use_pallas: bool = True
    band: Optional[int] = None
    max_alignments: Optional[int] = None
    mesh_shape: Optional[Tuple[int, int]] = None

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AlignConfig":
        """Build from ``dataclasses.asdict`` of either package's config."""
        d = dict(d)
        scoring = d.pop("scoring", None)
        if isinstance(scoring, Mapping):
            scoring = ScoringParams(**scoring)
        elif scoring is None:
            scoring = ScoringParams()
        for key in ("bucket_sizes", "mesh_shape"):
            if isinstance(d.get(key), list):
                d[key] = tuple(d[key])
        return cls(scoring=scoring, **d)

    def bucket_for(self, length: int) -> int:
        """Smallest configured bucket that holds ``length`` characters."""
        if self.bucket_sizes:
            for b in self.bucket_sizes:
                if length <= b:
                    return b
            return -(-length // 1024) * 1024
        return max(128, -(-length // 128) * 128)

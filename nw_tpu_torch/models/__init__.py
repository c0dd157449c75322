"""Alignment models: :mod:`nw_tpu_torch.models.needleman_wunsch`, global
alignment with linear gap penalties (one pair and batches), and
:mod:`nw_tpu_torch.models.smith_waterman`, local alignment (one pair and
batches)."""

from nw_tpu_torch.models.needleman_wunsch import (
    AlignmentResult,
    BatchResult,
    HugeAlignmentResult,
    NWAligner,
    align,
    align_batch,
)
from nw_tpu_torch.models.smith_waterman import (
    sw_align,
    sw_align_batch,
    sw_fill_diag,
    sw_score_batch,
    sw_traceback,
)

__all__ = [
    "AlignmentResult", "BatchResult", "HugeAlignmentResult", "NWAligner", "align",
    "align_batch", "sw_align", "sw_align_batch", "sw_fill_diag", "sw_score_batch",
    "sw_traceback",
]

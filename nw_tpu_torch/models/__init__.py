"""Alignment models: :mod:`nw_tpu_torch.models.needleman_wunsch`, global
alignment with linear gap penalties (one pair and batches)."""

from nw_tpu_torch.models.needleman_wunsch import (
    AlignmentResult,
    BatchResult,
    HugeAlignmentResult,
    NWAligner,
    align,
    align_batch,
)

__all__ = [
    "AlignmentResult", "BatchResult", "HugeAlignmentResult", "NWAligner", "align",
    "align_batch",
]

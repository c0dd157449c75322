"""Alignment models: :mod:`nw_tpu_torch.models.needleman_wunsch`, global
alignment with linear gap penalties (one pair and batches),
:mod:`nw_tpu_torch.models.smith_waterman`, local alignment (one pair and
batches), :mod:`nw_tpu_torch.models.overlap`, overlap (end-gap-free)
alignment (one pair and batches), and :mod:`nw_tpu_torch.models.affine`,
Gotoh affine-gap global scores."""

from nw_tpu_torch.models.affine import affine_score, affine_score_batch, affine_score_pairs
from nw_tpu_torch.models.needleman_wunsch import (
    AlignmentResult,
    BatchResult,
    HugeAlignmentResult,
    NWAligner,
    align,
    align_batch,
)
from nw_tpu_torch.models.overlap import (
    overlap_align,
    overlap_align_batch,
    overlap_fill_diag,
    overlap_score_batch,
    overlap_traceback,
)
from nw_tpu_torch.models.smith_waterman import (
    sw_align,
    sw_align_batch,
    sw_fill_diag,
    sw_score_batch,
    sw_traceback,
)

__all__ = [
    "AlignmentResult", "BatchResult", "HugeAlignmentResult", "NWAligner", "affine_align",
    "affine_align_batch", "affine_fill_arrows", "affine_score", "affine_score_batch",
    "affine_score_pairs", "affine_traceback", "align", "align_batch", "overlap_align",
    "overlap_align_batch", "overlap_fill_diag", "overlap_score_batch", "overlap_traceback",
    "sw_align", "sw_align_batch", "sw_fill_diag", "sw_score_batch", "sw_traceback",
]

"""Alignment models: :mod:`nw_tpu_torch.models.needleman_wunsch`, global
alignment with linear gap penalties (the batched path)."""

from nw_tpu_torch.models.needleman_wunsch import BatchResult, NWAligner, align_batch

__all__ = ["BatchResult", "NWAligner", "align_batch"]

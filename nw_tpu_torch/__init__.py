"""nw_tpu_torch — the Needleman-Wunsch engine of ``nw_tpu`` on PyTorch
and CUDA, for one NVIDIA H100.

Module names mirror ``nw_tpu`` so that each counterpart is easy to find.
The aligner (:class:`NWAligner`: ``align``, ``summary_huge``,
``align_huge``, ``align_batch``), the variant models
(:mod:`nw_tpu_torch.models`: Smith-Waterman, overlap and Gotoh
affine-gap scores and alignments), the byte-parity CLI
(``python -m nw_tpu_torch``), the batch CLI
(``python -m nw_tpu_torch.batch_cli``, all four models), the tie-mask
routes (:func:`nw_tpu_torch.ops.fill_auto.fill_arrows_auto`) and
Hirschberg's aligner (:func:`nw_tpu_torch.ops.hirschberg.hirschberg_align`)
run their fills
and walks through CUDA C++ kernels written for ``sm_90a``
(``csrc/``, built on first use by :mod:`nw_tpu_torch.runtime.kernels`);
every kernel has a plain PyTorch version beside it, which is what runs
when the caller passes ``device="cpu"``.  This package imports neither
JAX nor ``nw_tpu``.
"""

from nw_tpu_torch.config import AlignConfig, ScoringParams
from nw_tpu_torch.models.needleman_wunsch import (
    AlignmentResult,
    BatchResult,
    HugeAlignmentResult,
    NWAligner,
    align,
    align_batch,
)

__all__ = [
    "AlignConfig", "ScoringParams", "AlignmentResult", "BatchResult",
    "HugeAlignmentResult", "NWAligner", "align", "align_batch",
]

__version__ = "0.1.0"

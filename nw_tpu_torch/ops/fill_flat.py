"""Flat batched fills: the counterparts of ``nw_tpu/ops/fill_pallas.py``'s
public functions.

On the TPU these are the flat batch-in-lanes kernels, which keep a
128-pair block's whole anti-diagonal state in VMEM (sides up to ~2 kb):

* K7 ``_scores_kernel`` (``fill_pallas.py:103``, launched ``:230`` by
  ``fill_scores_pallas_batch``) -> :func:`fill_scores_flat_batch`;
* K26 ``_scores_counts_kernel`` (``:268``, launched ``:363`` by
  ``fill_scores_counts_pallas_batch``) -> :func:`fill_scores_counts_flat_batch`;
* K27 ``_make_arrows_kernel`` / ``_arrows_body`` (``:432`` / ``:456``,
  launched ``:648`` by ``fill_arrows_pallas_batch``) ->
  :func:`fill_arrows_flat_batch`;
* K6 ``_count_kernel`` over K27's words (``:703``, launched ``:784`` by
  ``count_packed_pallas_batch``) -> :func:`count_flat_batch`.

On the H100 the batched kernels of ``csrc/nw_fill.cu`` (32-row bands, a
block of W warps a pair, any side length) and
``csrc/nw_count.cu`` compute the same functions, so each TPU kernel here
is served by a hand-written kernel of the port that stands in for several
(ROADMAP's rule):

* K7 by ``nw_scores`` (:func:`nw_tpu_torch.ops.fill_banded.fill_scores_banded_batch`);
* K26 by ``nw_fill_codes`` with counts and no codes
  (:func:`nw_tpu_torch.ops.fill_banded.fill_scores_counts_banded_batch`);
* K27 by ``nw_fill_masks_batch``, with and without counts
  (:func:`nw_tpu_torch.ops.fill_banded.fill_masks_banded_batch`);
* K6 by ``nw_count_masks`` (:func:`nw_tpu_torch.ops.pathcount.count_masks_batch`).

Tie masks are the port's rectangular row-major uint8[B, Bs+1, A+1] (bit0
diag, bit1 left, bit2 up; row 0 LEFT, column 0 UP, the origin 0, 0
outside each true table), not K27's diagonal-major words: the contract
compares masks after decoding.  Counts come back as int64 in [0, 2^32)
(uint32 wraparound).  Each function has its plain version here; given
CPU tensors a function runs it, given CUDA tensors it launches its kernel
or raises.  The launches are counted by the serving wrappers above
(their ``.launches``), beside the kernel launch; the three functions
whose signature is the serving wrapper's are that wrapper.
"""

from __future__ import annotations

from nw_tpu_torch.ops import fill_banded, pathcount

# int32[B] optimal scores (K7's function; ``nw_scores``)
fill_scores_flat_batch = fill_banded.fill_scores_banded_batch
fill_scores_flat_batch_plain = fill_banded.fill_scores_banded_batch_plain

# (scores int32[B], counts int64[B] in [0, 2^32)) with nothing stored per
# cell (K26's function; ``nw_fill_codes`` in its counts mode without codes)
fill_scores_counts_flat_batch = fill_banded.fill_scores_counts_banded_batch
fill_scores_counts_flat_batch_plain = fill_banded.fill_scores_counts_banded_batch_plain

# int64[B] counts in [0, 2^32) from fill_arrows_flat_batch's masks (K6's
# function over K27's output; ``nw_count_masks``)
count_flat_batch = pathcount.count_masks_batch
count_flat_batch_plain = pathcount.count_masks_batch_plain


def fill_arrows_flat_batch(tops, sides, lens1, lens2, m, k, d, with_counts: bool = False):
    """(masks uint8[B, Bs+1, A+1], scores int32[B]), and counts int64[B]
    as a third output with ``with_counts`` (K27's function, its outputs
    in the port's layout; ``nw_fill_masks_batch``)."""
    masks, scores, counts = fill_banded.fill_masks_banded_batch(
        tops, sides, lens1, lens2, m, k, d, with_counts=with_counts
    )
    return (masks, scores, counts) if with_counts else (masks, scores)


def fill_arrows_flat_batch_plain(tops, sides, lens1, lens2, m, k, d, with_counts: bool = False):
    """Plain version of :func:`fill_arrows_flat_batch`."""
    masks, scores, counts = fill_banded.fill_masks_banded_batch_plain(
        tops, sides, lens1, lens2, m, k, d, with_counts=with_counts
    )
    return (masks, scores, counts) if with_counts else (masks, scores)

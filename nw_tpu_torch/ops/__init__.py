"""Fills, walks and host helpers.

* :mod:`nw_tpu_torch.ops.encode` — sequence encoding, padding, upload.
* :mod:`nw_tpu_torch.ops.fill_scan` — plain anti-diagonal fill (the
  version every fill kernel is held against).
* :mod:`nw_tpu_torch.ops.arrows` — the tie-mask bits.
* :mod:`nw_tpu_torch.ops.pathcount` — optimal-path counts (one pair, and
  a batch through the K6 port ``nw_count_masks``), optimal-cell marks and
  branch counts from tie masks.
* :mod:`nw_tpu_torch.ops.enumerate_walk` — host enumeration of every
  optimal alignment (native C++ walker, Python fallback).
* :mod:`nw_tpu_torch.ops.traceback` — greedy walks (codes, tie masks
  and run bytes) and op strings.
* :mod:`nw_tpu_torch.ops.fill_banded` — the K1 / K2 kernel wrappers, the
  batched tie masks (``fill_masks_banded_batch``) and run bytes
  (``fill_runs_banded_batch``) among them.
* :mod:`nw_tpu_torch.ops.fill_flat` — the flat-fill API of
  ``nw_tpu/ops/fill_pallas.py`` (K7, K26, K27, K6) on the batched kernels.
* :mod:`nw_tpu_torch.ops.fill_single` — the single-pair kernel wrappers
  (K8, K9's ``last_row``, K10's ``fill_arrows_fold_batch``, K11-K14).
* :mod:`nw_tpu_torch.ops.variants_banded` — the Smith-Waterman, overlap
  and Gotoh kernel wrappers (K15-K25).
* :mod:`nw_tpu_torch.ops.banded_traceback` — fill + walk of a batch,
  on the walk engine ``NW_TPU_WALK_ENGINE`` names (codes or runs).
* :mod:`nw_tpu_torch.ops.checkpoint_traceback` — one huge pair's walk
  from checkpoint rows (K12, K13, windowed walk).
* :mod:`nw_tpu_torch.ops.fill_auto` — score and tie-mask routing
  (``fill_scores_auto``, ``fill_arrows_auto``).
* :mod:`nw_tpu_torch.ops.hirschberg` — Hirschberg's linear-space
  alignment (``hirschberg_align``) on K9's port.
"""

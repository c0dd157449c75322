"""Fills, walks and host helpers.

* :mod:`nw_tpu_torch.ops.encode` — sequence encoding, padding, upload.
* :mod:`nw_tpu_torch.ops.fill_scan` — plain anti-diagonal fill (the
  version every fill kernel is held against).
* :mod:`nw_tpu_torch.ops.pathcount` — optimal-path counts, optimal-cell
  marks and branch counts from tie masks.
* :mod:`nw_tpu_torch.ops.enumerate_walk` — host enumeration of every
  optimal alignment (native C++ walker, Python fallback).
* :mod:`nw_tpu_torch.ops.traceback` — greedy walks and op strings.
* :mod:`nw_tpu_torch.ops.fill_banded` — the K1 / K2 kernel wrappers.
* :mod:`nw_tpu_torch.ops.fill_single` — the single-pair kernel wrappers
  (K8, K11-K14).
* :mod:`nw_tpu_torch.ops.variants_banded` — the Smith-Waterman, overlap
  and Gotoh kernel wrappers (K15-K25).
* :mod:`nw_tpu_torch.ops.banded_traceback` — code fill + walk.
* :mod:`nw_tpu_torch.ops.checkpoint_traceback` — one huge pair's walk
  from checkpoint rows (K12, K13, windowed walk).
* :mod:`nw_tpu_torch.ops.fill_auto` — score routing.
"""

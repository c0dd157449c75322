"""Checkpoint and resume for long batch runs.

Counterpart of ``nw_tpu/runtime/checkpoint.py``: :class:`CheckpointedRunner`
(``:24-118``), :class:`ResumableBandedTraceback` (``:121``) and
:class:`ResumableBandedFill` (``:481``); ``ResumableHugePair`` (``:346``)
is not ported yet (ROADMAP.md queue 1).

A multi-hour batch alignment must survive preemption.
:class:`CheckpointedRunner` splits a pair batch into chunks, persists each
chunk's results (scores, counts, alignment strings) as
``chunk_XXXXX.npz`` next to a manifest, and on restart skips chunks whose
files already exist, so a re-run after preemption costs only the
in-flight chunk.  :class:`ResumableBandedFill` persists one banded fill's
carry (the boundary row, its counts, the scores and counts so far, the
next band) every ``save_every`` bands; :class:`ResumableBandedTraceback`
persists the two-pass walk's (the checkpoint rows, the walk cursor and
the op prefixes) every ``save_every`` groups.  A killed run resumes from
its last completed span, bit for bit the uninterrupted run.

Files are written atomically (tmp + rename), so a file either exists
complete or not at all, and each state is keyed by the run's shape and
scoring: a directory written by another run raises ``ValueError``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class CheckpointedRunner:
    def __init__(self, directory: str, chunk_size: int = 1024, key: str = ""):
        """``key`` identifies the computation (scoring, mode, flags).  It
        is stored in the manifest and checked on resume, so a directory of
        chunk files from a *different* computation is rejected instead of
        silently concatenated into mixed results."""
        self.directory = directory
        self.chunk_size = chunk_size
        self.key = key
        os.makedirs(directory, exist_ok=True)

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self.directory, f"chunk_{idx:05d}.npz")

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def run(
        self,
        pairs: Sequence[Tuple[bytes, bytes]],
        align_chunk: Callable[[Sequence[Tuple[bytes, bytes]]], Dict[str, np.ndarray]],
        progress: Optional[Callable[[int, int], None]] = None,
        retries: int = 0,
    ) -> Dict[str, np.ndarray]:
        """Run ``align_chunk`` over chunks, resuming from existing files.

        align_chunk: maps a list of pairs to a dict of equal-length
        arrays (e.g. {"scores": ...}).  Returns the concatenated dict.
        progress: called as ``progress(c, nchunks)`` after chunk c is
        done, loaded from its file or computed.
        retries: re-attempt a failing chunk this many times before
        propagating (a transient device or runtime failure requeues the
        chunk instead of losing the run; completed chunks are never
        recomputed either way).
        """
        n = len(pairs)
        nchunks = -(-n // self.chunk_size) if n else 0
        manifest = {
            "total_pairs": n,
            "chunk_size": self.chunk_size,
            "num_chunks": nchunks,
            "key": self.key,
        }
        mpath = self._manifest_path()
        if os.path.exists(mpath):
            with open(mpath) as f:
                old = json.load(f)
            if (old["total_pairs"], old["chunk_size"], old.get("key", "")) != (
                n, self.chunk_size, self.key,
            ):
                raise ValueError(
                    f"checkpoint dir {self.directory} was written by a "
                    f"different run shape/computation: {old}"
                )
        else:
            tmp = mpath + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, mpath)

        results = []
        for c in range(nchunks):
            path = self._chunk_path(c)
            if os.path.exists(path):
                with np.load(path) as saved:
                    results.append(dict(saved))
                if progress:
                    progress(c, nchunks)
                continue
            chunk = pairs[c * self.chunk_size : (c + 1) * self.chunk_size]
            attempt = 0
            while True:
                try:
                    out = align_chunk(chunk)
                    break
                except Exception:
                    attempt += 1
                    if attempt > retries:
                        raise
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **out)
            os.replace(tmp, path)
            results.append({k: np.asarray(v) for k, v in out.items()})
            if progress:
                progress(c, nchunks)

        if not results:
            return {}
        keys = results[0].keys()
        return {k: np.concatenate([r[k] for r in results]) for k in keys}


def _save_atomic(path: str, **arrays) -> None:
    """``np.savez`` of ``arrays`` to ``path`` through a temporary file
    and a rename."""
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _check_key(path: str, key: dict) -> None:
    """Raise ``ValueError`` unless the key stored at ``path`` is ``key``;
    store it where none is."""
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if old != key:
            raise ValueError(f"checkpoint at {path} is from a different run: {old}")
        return
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(key, f)
    os.replace(tmp, path)


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy()


def _preempt(spans: int, abort_after: Optional[int]) -> None:
    if abort_after and spans >= abort_after:
        raise KeyboardInterrupt("simulated preemption")


class ResumableBandedFill:
    """Mid-fill checkpoint and resume for one banded fill of a batch.

    The fill's whole cross-band state is the boundary row (with counts,
    its counts row) and the scores and counts of the pairs whose corners
    it has passed: a row a pair, whatever the depth.  The runner sweeps
    ``save_every`` 32-row bands at a time (``nw_fill_span`` on CUDA
    tensors, its plain version on CPU tensors) and persists that carry
    and the next band atomically after each span (``fill_state.npz``, a
    row a pair: each save rewrites only it; ``key.json`` holds the run's
    shape and scoring), so a preempted fill resumes from its last span,
    bit for bit the uninterrupted fill.
    """

    def __init__(self, directory: str, save_every: int = 16):
        self.directory = directory
        self.save_every = save_every
        os.makedirs(directory, exist_ok=True)

    def _state_path(self) -> str:
        return os.path.join(self.directory, "fill_state.npz")

    def run(self, tops, sides, lens1, lens2, m: int, k: int, d: int, with_counts: bool = False,
            _abort_after_spans: Optional[int] = None):
        """The banded fill of an encoded batch (int32 tensors on one
        device, :func:`nw_tpu_torch.ops.encode.upload`), optionally with
        its fused counts, with a save after every span.  Returns scores
        int32[B] (and counts uint32[B]), host arrays.

        ``_abort_after_spans`` is a test hook: raise ``KeyboardInterrupt``
        (as a preemption would) after that many spans, unless the fill is
        done."""
        from nw_tpu_torch.ops.fill_banded import _check, fill_span_banded_batch, span_row0

        _check(tops, sides, lens1, lens2, m, k, d)
        B, A = tops.shape
        Bs = sides.shape[1]
        dev = tops.device
        S = self.save_every
        if S < 1:
            raise ValueError(f"save_every must be >= 1, not {S}")
        nbands = -(-Bs // 32)
        _check_key(os.path.join(self.directory, "key.json"), dict(
            nb=B, A=A, Bs=Bs, m=int(m), k=int(k), d=int(d), with_counts=with_counts, save_every=S,
        ))
        spath = self._state_path()
        if os.path.exists(spath):
            with np.load(spath) as saved:
                r = int(saved["r_next"])
                carry = {n: torch.from_numpy(saved[n]).to(dev) if n in saved.files else None
                         for n in ("bnd", "cbnd", "scores", "counts")}
            bnd, cbnd, scores, counts = (carry[n] for n in ("bnd", "cbnd", "scores", "counts"))
        else:
            r = 0
            bnd, cbnd = span_row0(B, A, d, with_counts, dev)
            scores = torch.zeros(B, dtype=torch.int32, device=dev)
            counts = torch.zeros_like(scores) if with_counts else None
        spans = 0
        while r < nbands or r == 0:  # a table of no band: one span writes the row-0 corners
            fill_span_banded_batch(tops, sides, lens1, lens2, m, k, d, r, S, bnd, cbnd, scores, counts)
            r += S
            saved = dict(r_next=r, bnd=_host(bnd), scores=_host(scores))
            if with_counts:
                saved.update(cbnd=_host(cbnd), counts=_host(counts))
            _save_atomic(spath, **saved)
            spans += 1
            if r < nbands:
                _preempt(spans, _abort_after_spans)
        out = scores.cpu().numpy()
        if with_counts:
            return out, counts.cpu().numpy().view(np.uint32)
        return out


class ResumableBandedTraceback:
    """Mid-run checkpoint and resume for the two-pass banded traceback
    (:class:`nw_tpu_torch.ops.banded_traceback.TwoPass`, the ``twopass``
    engine's groups of ``GROUP_BANDS`` 32-row bands).

    Both passes persist their carry atomically every ``save_every``
    groups, each span writing only its own rows:

    * pass 1 (the checkpoint sweep): each group's checkpoint row as
      ``cp_XXXXX.npy``, then the sweep's carry (the boundary row and its
      counts, the scores and counts so far, the next group) as
      ``pass1.npz``;
    * pass 2 (the walk, last group first): each span's per-group op
      prefixes, 2-bit packed, and their lengths as ``ops_XXXXX.npz``,
      then the walk cursor (i, j, n a pair) and the groups done as
      ``pass2.npz``.

    ``key.json`` holds the run's shape and scoring.  A killed run resumes
    from its last completed span and returns bit for bit the
    uninterrupted run's (scores[, counts], ops, n): the persisted carry
    is the computation's only cross-group state.
    """

    def __init__(self, directory: str, save_every: int = 4):
        self.directory = directory
        self.save_every = save_every
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def run(self, tops, sides, lens1, lens2, m: int, k: int, d: int, with_counts: bool = False,
            _abort_after_spans: Optional[int] = None):
        """Returns (scores int32[B], ops int8[B, A+Bs], n int32[B]), or
        (scores, counts uint32[B], ops, n) with ``with_counts``, host
        arrays equal to :func:`nw_tpu_torch.ops.banded_traceback.traceback_banded_batch`'s
        on an encoded batch (int32 tensors on one device).

        ``_abort_after_spans`` is a test hook: raise ``KeyboardInterrupt``
        (as a preemption would) after that many spans, counted across
        both passes: every span of pass 1 (its last one ends between the
        passes) and every span of pass 2 but its last."""
        from nw_tpu_torch.ops.banded_traceback import TwoPass, compact_group_ops

        tp = TwoPass(tops, sides, lens1, lens2, m, k, d, with_counts)
        G, dev = tp.ngroups, tp.device
        S = self.save_every
        if S < 1:
            raise ValueError(f"save_every must be >= 1, not {S}")
        # the group height is the run's shape: it says which rows the checkpoint files hold
        _check_key(self._path("key.json"), dict(
            nb=tp.B, A=tp.A, Bs=tp.Bs, m=int(m), k=int(k), d=int(d), with_counts=with_counts,
            ngroups=G, group_bands=tp.S, save_every=S,
        ))
        spans = 0

        def load(name):
            with np.load(self._path(name)) as saved:
                return {n: saved[n] for n in saved.files}

        def to_dev(a):
            return torch.from_numpy(a).to(dev)

        def keep(g, bnd):  # pass 1: each group's checkpoint row, a file of its own
            cp = self._path(f"cp_{g:05d}.npy")
            tmp = cp + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.save(f, _host(bnd))
            os.replace(tmp, cp)

        def saved1(done):
            nonlocal spans
            saved = dict(g1=done, bnd=_host(bnd), scores=_host(scores))
            if with_counts:
                saved.update(cbnd=_host(cbnd), counts=_host(counts))
            _save_atomic(self._path("pass1.npz"), **saved)
            spans += 1
            _preempt(spans, _abort_after_spans)

        def saved2(done, ops4, ng):
            nonlocal spans
            _save_atomic(self._path(f"ops_{done - ng.shape[0]:05d}.npz"), ops4=_host(ops4), ng=_host(ng))
            _save_atomic(self._path("pass2.npz"), g2=done, state=_host(state))
            spans += 1
            if done < G:
                _preempt(spans, _abort_after_spans)

        if os.path.exists(self._path("pass1.npz")):
            p1 = load("pass1.npz")
            g1 = int(p1["g1"])
            bnd, scores = to_dev(p1["bnd"]), to_dev(p1["scores"])
            cbnd, counts = (to_dev(p1["cbnd"]), to_dev(p1["counts"])) if with_counts else (None, None)
        else:
            g1 = 0
            bnd, cbnd, scores, counts = tp.start()
        tp.checkpoint_pass((bnd, cbnd, scores, counts), keep, g1, S, saved1)
        del bnd, cbnd

        if os.path.exists(self._path("pass2.npz")):
            p2 = load("pass2.npz")
            g2, state = int(p2["g2"]), to_dev(p2["state"])
        else:
            g2, state = 0, tp.cursor()
        tp.walk_pass(lambda g: to_dev(np.load(self._path(f"cp_{g:05d}.npy"))), state, done=g2, every=S,
                     on_span=saved2)

        parts = [load(f"ops_{x:05d}.npz") for x in range(0, G, S)]
        ops, n = compact_group_ops(np.concatenate([p["ops4"] for p in parts]),
                                   np.concatenate([p["ng"] for p in parts]), tp.width)
        out_scores = scores.cpu().numpy()
        if with_counts:
            return out_scores, counts.cpu().numpy().view(np.uint32), ops, n
        return out_scores, ops, n

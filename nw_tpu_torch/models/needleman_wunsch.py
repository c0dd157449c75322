"""Global alignment with linear gap penalties.

Counterpart of ``nw_tpu/models/needleman_wunsch.py``:

* ``NWAligner.align`` — one pair's whole table (tie masks, scores),
  score and solution count, for enumeration and ``-t`` rendering
  (``nw_fill_masks``);
* ``NWAligner.summary_huge`` — one pair's score and solution count in
  O(A+B) memory (``nw_score_count``, the K8 port);
* ``NWAligner.align_huge`` — the exact first-emitted alignment of one
  huge pair (100 kb and more), by one of two routes (:meth:`NWAligner._huge_ops`):
  the whole pair's 2-bit codes (``nw_fill_codes_single``, the K14 port)
  and one ``nw_walk`` when they fit ``NW_TPU_HUGE_WALK_HBM``, else the
  checkpointed re-fill (:mod:`nw_tpu_torch.ops.checkpoint_traceback`:
  K12, K13 and the windowed walk);
* ``NWAligner.align_huge_sharded`` — the same for a pair whose rows are
  sharded over the ranks of a mesh (:mod:`nw_tpu_torch.parallel.huge_pair`);
* ``NWAligner.align_batch`` — a batch of pairs padded to a length bucket:
  int32 scores, uint32 solution counts and the greedy first-emitted
  alignment of each pair.

``align_batch``'s routes, by what the caller asks for:

* scores only -> :func:`nw_tpu_torch.ops.fill_auto.fill_scores_auto`
  (``nw_scores``; a small batch of long pairs one pair at a time through
  ``nw_score_single``, the K11 port);
* counts only -> :func:`nw_tpu_torch.ops.fill_banded.fill_scores_counts_banded_batch`
  (``nw_fill_codes`` without codes);
* strings, with or without counts -> sub-batches through
  :func:`nw_tpu_torch.ops.banded_traceback.traceback_banded_dispatch`
  on the walk engine ``NW_TPU_WALK_ENGINE`` names: ``nw_fill_codes``
  then ``nw_walk`` (``auto``, ``onepass``), or ``nw_fill_runs_batch``
  then ``nw_walk_runs`` (``runs``).  This route stores a value per cell
  (2 bits of code, or a run byte), so it is cut into sub-batches, sized
  by :func:`strings_sub_batch` so that one sub-batch's table fits
  :data:`CODE_BUDGET_BYTES`; every engine gives the same outputs;
* counts or strings of fewer than ``BANDED_MIN_BATCH`` pairs with sides
  over ``HUGE_PAIR_MIN_SIDE`` -> one pair at a time: counts through
  ``summary_huge``, strings through ``align_huge``'s routes;
* counts or strings of a small batch of long pairs
  (:func:`nw_tpu_torch.ops.fill_auto.takes_mask_route`) -> tie masks a
  pair at a time with the fused count
  (:func:`nw_tpu_torch.ops.fill_single.fill_arrows_fold_batch`, K10's
  port), then one walk of the sub-batch over them
  (:func:`nw_tpu_torch.ops.traceback.walk_masks_batch`), as ``nw_tpu``
  routes that shape (``needleman_wunsch.py:636-647``); sub-batches keep
  the masks inside :data:`CODE_BUDGET_BYTES`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nw_tpu_torch.config import AlignConfig, ScoringParams
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import enumerate_walk, traceback
from nw_tpu_torch.ops.banded_traceback import (
    ENGINE_CELL_BITS,
    resolve_walk_engine,
    traceback_banded_dispatch,
    traceback_banded_finalize,
)
from nw_tpu_torch.ops.fill_auto import (
    BANDED_MIN_BATCH,
    HUGE_PAIR_MIN_SIDE,
    fill_scores_auto,
    takes_mask_route,
)
from nw_tpu_torch.ops.fill_banded import (
    code_shape,
    fill_arrows_banded_single,
    fill_scores_counts_banded_batch,
)
from nw_tpu_torch.ops.checkpoint_traceback import huge_walk_budget, traceback_checkpointed
from nw_tpu_torch.ops.fill_single import fill_arrows_fold_batch, fill_codes_single, score_count_fold

# device bytes one strings sub-batch may spend on its per-cell table: at
# 10 kb buckets 653 pairs of 2-bit codes (26 MB a pair), i.e. several
# warps per SM, or 163 pairs of run bytes (105 MB a pair); the mask
# route's sub-batches spend it on tie masks (a byte a cell)
CODE_BUDGET_BYTES = 16 << 30


def _as_bytes(s: str | bytes) -> bytes:
    return s.encode() if isinstance(s, str) else bytes(s)


def _rescore(X: bytes, Y: bytes, m: int, k: int, d: int) -> int:
    """The score of an alignment in Python ints (no int32 wrap), as
    ``nw_tpu``'s ``align_huge`` derives it (needleman_wunsch.py:196-204)."""
    score = 0
    for x, y in zip(X, Y):
        if x == ord("-") or y == ord("-"):
            score -= d
        elif x == y:
            score += m
        else:
            score -= k
    return score


def resolve_device(device: str | torch.device, who: str) -> torch.device:
    """``device`` as a torch device: ``cuda`` (which must be present) or
    ``cpu``; there is no fallback from one to the other."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who} runs on 'cuda' or 'cpu', not {dev}")
    return dev


def code_bytes_per_pair(L1: int, L2: int, bits: int = 2) -> int:
    """Device bytes of one pair's per-cell table at buckets (L1, L2):
    2-bit greedy codes, ``bits=4`` Gotoh codes, or ``bits=8`` run bytes
    (uint8[L2+1, L1+1])."""
    if bits == 8:
        return (L1 + 1) * (L2 + 1)
    _, nbands, TW, lanes = code_shape(1, L1, L2, bits)
    return nbands * TW * lanes * 4


def strings_sub_batch(L1: int, L2: int, engine: str) -> int:
    """Pairs a strings sub-batch takes at buckets (L1, L2) on the walk
    engine ``engine``: as many as fit :data:`CODE_BUDGET_BYTES` at the
    bits a cell the engine stores (2 for codes, 8 for run bytes)."""
    bits = ENGINE_CELL_BITS[engine]
    return max(1, CODE_BUDGET_BYTES // code_bytes_per_pair(L1, L2, bits))


@dataclasses.dataclass
class AlignmentResult:
    """Result for a single pair (host numpy arrays).

    The tables are rectangular, row j / column i, as ``nw_fill_masks``
    writes them; ``nw_tpu``'s diagonal-major ``arrows_diag`` /
    ``scores_diag`` fields have no counterpart here.
    """

    s1: bytes
    s2: bytes
    score: int
    solution_count: int
    arrows: Optional[np.ndarray] = None  # uint8[N, M] tie masks
    score_matrix: Optional[np.ndarray] = None  # int32[N, M]

    def alignments(
        self, max_alignments: Optional[int] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        """All optimal alignments in reference DFS order (diag>left>up)."""
        return enumerate_walk.iter_alignments(
            self.arrows, self.s1, self.s2, max_alignments
        )

    def best_alignment(self) -> Tuple[bytes, bytes]:
        """First optimal alignment (== the reference's first-emitted one)."""
        for a in self.alignments(max_alignments=1):
            return a
        return b"", b""


@dataclasses.dataclass
class BatchResult:
    """Result for a batch of pairs (host numpy arrays)."""

    scores: np.ndarray  # int32[B] optimal scores
    counts: Optional[np.ndarray] = None  # uint32[B] optimal-alignment counts
    ops: Optional[np.ndarray] = None  # int8[B, S] greedy traceback op codes
    ops_len: Optional[np.ndarray] = None  # int32[B]
    status: Optional[np.ndarray] = None  # uint8[B]: 0 = ok, 1 = rejected
    _pairs: Optional[Sequence[Tuple[bytes, bytes]]] = None

    STATUS_OK = 0
    STATUS_TOO_LONG = 1

    def alignment_strings(self) -> List[Tuple[bytes, bytes]]:
        """One (first-)optimal aligned pair of byte strings per input."""
        if self.ops is None:
            raise ValueError("batch was run without traceback_strings")
        return traceback.ops_to_strings_batch(self.ops, self.ops_len, self._pairs)


@dataclasses.dataclass
class HugeAlignmentResult:
    """Result of :meth:`NWAligner.align_huge`: the first-emitted
    alignment, with no per-cell table kept."""

    s1: bytes
    s2: bytes
    score: int
    X: bytes  # aligned top string (with '-' gaps)
    Y: bytes  # aligned side string


class NWAligner:
    """Needleman-Wunsch aligner configured once, applied to many inputs.

    ``device`` is where the fills run: ``"cuda"`` (the default) launches
    the CUDA kernels, ``"cpu"`` runs their plain PyTorch versions.  There
    is no fallback from one to the other.
    """

    def __init__(
        self, config: AlignConfig | None = None, device: str | torch.device = "cuda",
        **scoring_kwargs,
    ):
        if config is None:
            config = AlignConfig(scoring=ScoringParams(**scoring_kwargs))
        self.config = config
        self.device = resolve_device(device, "NWAligner")

    def _encode_pair(self, s1: bytes, s2: bytes):
        return enc.upload((enc.encode(s1), enc.encode(s2)), self.device)

    def align(self, s1: str | bytes, s2: str | bytes) -> AlignmentResult:
        """Align one pair, returning its tie masks and scores for
        enumeration and table rendering, its score and its solution
        count (``nw_tpu`` ``needleman_wunsch.py:137``)."""
        s1b, s2b = _as_bytes(s1), _as_bytes(s2)
        m, k, d = self.config.scoring.as_tuple()
        masks, scores, score, count = fill_arrows_banded_single(
            *self._encode_pair(s1b, s2b), m, k, d, with_scores=True
        )
        return AlignmentResult(
            s1=s1b,
            s2=s2b,
            score=score,
            solution_count=0 if not s1b and not s2b else count,  # 1x1: no DFS emission
            arrows=masks.cpu().numpy(),
            score_matrix=scores.cpu().numpy(),
        )

    def summary_huge(self, s1: str | bytes, s2: str | bytes) -> Tuple[int, int]:
        """(optimal score, solution count mod 2^32) of one pair in a
        single O(A+B)-memory pass — the reference ``-s`` summary
        (computation.c:271-281) at scales where no table fits
        (``nw_tpu`` ``needleman_wunsch.py:271``)."""
        s1b, s2b = _as_bytes(s1), _as_bytes(s2)
        m, k, d = self.config.scoring.as_tuple()
        score, count = score_count_fold(*self._encode_pair(s1b, s2b), m, k, d)
        return score, 0 if not s1b and not s2b else count

    def align_huge(
        self, s1: str | bytes, s2: str | bytes, block_diagonals: Optional[int] = None
    ) -> HugeAlignmentResult:
        """Exact first-emitted alignment of ONE huge pair (100 kb and
        more), byte-identical to the reference DFS's first emission
        (needleman-wunsch.c:305-324) and to ``nw_tpu``'s ``align_huge``.

        Route (:meth:`_huge_ops`): when ``block_diagonals`` is None and
        the pair's 2-bit codes (:func:`code_bytes_per_pair`) fit
        ``NW_TPU_HUGE_WALK_HBM`` bytes (:func:`huge_walk_budget`, default
        8 GiB; a 100 000 bp pair needs 2.5 GB), one fill of the whole
        pair's codes and one walk; the score is the fill's corner.
        Otherwise the checkpointed re-fill
        (:func:`nw_tpu_torch.ops.checkpoint_traceback.traceback_checkpointed`),
        O(A B / C + C A) memory; the score is derived from the alignment
        in Python ints.  ``block_diagonals`` keeps ``nw_tpu``'s name: in
        the port it is the rows each block re-fills, rounded up to a
        multiple of 32.  It changes memory and time, never the output.
        """
        s1b, s2b = _as_bytes(s1), _as_bytes(s2)
        ops, n, score = self._huge_ops(*self._encode_pair(s1b, s2b), block_diagonals)
        X, Y = traceback.ops_to_strings(ops, n, s1b, s2b)
        if score is None:
            score = _rescore(X, Y, *self.config.scoring.as_tuple())
        return HugeAlignmentResult(s1=s1b, s2=s2b, score=score, X=X, Y=Y)

    def align_huge_sharded(
        self, s1: str | bytes, s2: str | bytes, mesh, axis: str = "seq",
        chunk: Optional[int] = None,
    ) -> HugeAlignmentResult:
        """Exact first-emitted alignment of ONE pair too large for one
        device (``nw_tpu`` ``needleman_wunsch.py:246``): its rows tiled
        over ``mesh``'s ``axis`` (BASELINE config 5; the tile wavefront,
        the chunked halo and the relay walk of
        :mod:`nw_tpu_torch.parallel.huge_pair`).  Collective: every rank
        calls it with the same pair and gets the same result, equal to
        :meth:`align_huge`'s codes route.  ``chunk``: columns a tile."""
        from nw_tpu_torch.parallel.huge_pair import huge_pair_align_sharded

        s1b, s2b = _as_bytes(s1), _as_bytes(s2)
        m, k, d = self.config.scoring.as_tuple()
        r = huge_pair_align_sharded(
            enc.encode(s1b), enc.encode(s2b), m, k, d, mesh, axis=axis, chunk=chunk,
            device=self.device,
        )
        X, Y = traceback.ops_to_strings(r.ops, r.n, s1b, s2b)
        return HugeAlignmentResult(s1=s1b, s2=s2b, score=r.score, X=X, Y=Y)

    def _huge_ops(self, top, side, block_diagonals=None):
        """(ops int8[n] on the host, n, score or None) of ONE huge pair:
        ``align_huge``'s route choice (``nw_tpu``
        ``needleman_wunsch.py:207-244``).  The budget rule alone decides;
        a failed allocation or launch raises."""
        m, k, d = self.config.scoring.as_tuple()
        len1, len2 = top.shape[0], side.shape[0]
        if block_diagonals is None and code_bytes_per_pair(len1, len2) <= huge_walk_budget():
            codes, score = fill_codes_single(top, side, m, k, d)
            lens = [torch.tensor([x], dtype=torch.int32, device=self.device) for x in (len1, len2)]
            ops, n = traceback.walk_codes_batch(codes, *lens, max(len1 + len2, 1))
            n = int(n[0])
            return ops[0, :n].cpu().numpy(), n, int(score)
        ops, n = traceback_checkpointed(top, side, m, k, d, block_diagonals=block_diagonals)
        n = int(n)
        return ops[:n].cpu().numpy(), n, None

    def _align_batch_huge_pairs(self, norm, status, traceback_strings, count) -> BatchResult:
        """A small batch of huge pairs, one pair at a time (``nw_tpu``
        ``needleman_wunsch.py:290-341``): strings through
        :meth:`_huge_ops`, counts through :meth:`summary_huge`.  The
        strings' route gives a score too (the corner, or the alignment
        re-scored and wrapped to int32, as ``nw_tpu``'s int32 sum is):
        it is the score without counts, and with counts it must equal
        the summary's, else RuntimeError."""
        m, k, d = self.config.scoring.as_tuple()
        nb = len(norm)
        scores = np.zeros(nb, np.int32)
        counts = np.zeros(nb, np.uint32) if count else None
        S = max((len(a) + len(b) for a, b in norm), default=1)
        ops_arr = np.full((nb, max(S, 1)), traceback.OP_NONE, np.int8) if traceback_strings else None
        ns = np.zeros(nb, np.int32)
        for i, (a, b) in enumerate(norm):
            if traceback_strings:
                ops, ns[i], walked = self._huge_ops(*self._encode_pair(a, b))
                ops_arr[i, : ns[i]] = ops
                if walked is None:
                    X, Y = traceback.ops_to_strings(ops_arr[i], int(ns[i]), a, b)
                    walked = (_rescore(X, Y, m, k, d) + 2**31) % 2**32 - 2**31
                scores[i] = walked
            if count:
                scores[i], counts[i] = self.summary_huge(a, b)
                if traceback_strings and walked != scores[i]:
                    raise RuntimeError(
                        f"pair {i}: the walk's score {walked} differs from the "
                        f"summary's {scores[i]}"
                    )
        result = BatchResult(scores=scores, counts=counts, status=status, _pairs=norm)
        if traceback_strings:
            result.ops, result.ops_len = ops_arr, ns
        return result

    def _align_batch_masks(self, norm, status, traceback_strings, count, L1, L2) -> BatchResult:
        """A small batch of long pairs on the mask route: sub-batches whose
        tie masks fit :data:`CODE_BUDGET_BYTES`, each filled a pair at a
        time (``nw_fill_masks``, scores and fused counts) and walked at
        once (``nw_walk_masks``); the same outputs as the codes route."""
        m, k, d = self.config.scoring.as_tuple()
        chunk = max(1, CODE_BUDGET_BYTES // ((L1 + 1) * (L2 + 1)))
        scores_l, counts_l, ops_l, n_l = [], [], [], []
        for lo in range(0, len(norm), chunk):
            tops, sides, l1, l2 = enc.upload(enc.encode_batch(norm[lo : lo + chunk], L1, L2), self.device)
            masks, sc, ct = fill_arrows_fold_batch(tops, sides, l1, l2, m, k, d)
            scores_l.append(sc.cpu().numpy())
            if count:
                counts_l.append(ct.cpu().numpy().astype(np.uint32))
            if traceback_strings:
                ops, n = traceback.walk_masks_batch(masks, l1, l2, max(L1 + L2, 1))
                ops_l.append(ops.cpu().numpy())
                n_l.append(n.cpu().numpy())
            del masks
        result = BatchResult(scores=np.concatenate(scores_l), status=status, _pairs=norm)
        if count:
            result.counts = np.concatenate(counts_l)
        if traceback_strings:
            result.ops, result.ops_len = np.concatenate(ops_l), np.concatenate(n_l)
        return result

    def align_batch(
        self,
        pairs: Sequence[Tuple[str | bytes, str | bytes]],
        traceback_strings: bool = False,
        count: bool = False,
        max_length: Optional[int] = None,
        on_error: str = "raise",
        sub_batch: Optional[int] = None,
    ) -> BatchResult:
        """Score a batch of pairs; optionally count optimal alignments
        and trace back the first-emitted one.

        With ``on_error="mask"``, pairs longer than ``max_length`` are
        replaced by empty pairs and flagged in ``result.status`` instead
        of failing the whole batch.  ``sub_batch`` caps the pairs per
        strings sub-batch (default: :func:`strings_sub_batch` on the walk
        engine ``NW_TPU_WALK_ENGINE`` names).
        """
        if on_error not in ("raise", "mask"):
            raise ValueError(f"on_error must be 'raise' or 'mask', not {on_error!r}")
        m, k, d = self.config.scoring.as_tuple()
        norm = [(_as_bytes(a), _as_bytes(b)) for a, b in pairs]
        status = np.zeros((len(norm),), np.uint8)
        if max_length is not None:
            bad = [
                i for i, (a, b) in enumerate(norm)
                if len(a) > max_length or len(b) > max_length
            ]
            if bad and on_error == "raise":
                raise ValueError(
                    f"{len(bad)} pair(s) exceed max_length={max_length} "
                    f"(first: index {bad[0]}); pass on_error='mask' to "
                    "isolate them"
                )
            for i in bad:
                status[i] = BatchResult.STATUS_TOO_LONG
                norm[i] = (b"", b"")
        L1 = self.config.bucket_for(max((len(a) for a, _ in norm), default=1))
        L2 = self.config.bucket_for(max((len(b) for _, b in norm), default=1))

        if not (traceback_strings or count):
            tops, sides, l1, l2 = enc.upload(enc.encode_batch(norm, L1, L2), self.device)
            scores = fill_scores_auto(tops, sides, l1, l2, m, k, d)
            return BatchResult(scores=scores.cpu().numpy(), status=status, _pairs=norm)

        if L2 > HUGE_PAIR_MIN_SIDE and len(norm) < BANDED_MIN_BATCH:
            return self._align_batch_huge_pairs(norm, status, traceback_strings, count)
        if takes_mask_route(len(norm), L1, L2):
            return self._align_batch_masks(norm, status, traceback_strings, count, L1, L2)
        if not traceback_strings:
            tops, sides, l1, l2 = enc.upload(enc.encode_batch(norm, L1, L2), self.device)
            scores, counts = fill_scores_counts_banded_batch(
                tops, sides, l1, l2, m, k, d
            )
            return BatchResult(
                scores=scores.cpu().numpy(),
                counts=counts.cpu().numpy().astype(np.uint32),
                status=status, _pairs=norm,
            )

        engine = resolve_walk_engine()
        if sub_batch is None:
            sub_batch = strings_sub_batch(L1, L2, engine)
        scores_l, counts_l, ops_l, n_l = _pipelined_banded_walk(
            norm, m, k, d, sub_batch, count, L1, L2, self.device, engine
        )
        result = BatchResult(
            scores=np.concatenate(scores_l),
            ops=np.concatenate(ops_l),
            ops_len=np.concatenate(n_l),
            status=status,
            _pairs=norm,
        )
        if count:
            result.counts = np.concatenate(counts_l)
        return result


def _pipelined_banded_walk(norm, m, k, d, chunk, count, L1, L2, device, engine):
    """Banded tracebacks over sub-batches of ``chunk`` pairs on the walk
    engine ``engine``.

    Every sub-batch is padded to the whole batch's buckets (L1, L2), so
    their op arrays share one width and concatenate.  Sub-batches run in
    order: dispatch, then finalize (the host copy), then the next one.
    """
    scores_l, counts_l, ops_l, n_l = [], [], [], []
    for lo in range(0, max(len(norm), 1), chunk):
        sub = norm[lo : lo + chunk]
        tops, sides, l1, l2 = enc.upload(enc.encode_batch(sub, L1, L2), device)
        outs = traceback_banded_finalize(
            traceback_banded_dispatch(tops, sides, l1, l2, m, k, d, with_counts=count, engine=engine)
        )
        if count:
            sc, ct, ops, n = outs
            counts_l.append(ct)
        else:
            sc, ops, n = outs
        scores_l.append(sc)
        ops_l.append(ops)
        n_l.append(n)
    return scores_l, counts_l, ops_l, n_l


def align(s1, s2, m: int = 1, k: int = 1, d: int = 1, device: str = "cuda") -> AlignmentResult:
    """One-shot single-pair alignment (reference CLI semantics)."""
    return NWAligner(AlignConfig(scoring=ScoringParams(m, k, d)), device=device).align(s1, s2)


def align_batch(
    pairs, m: int = 1, k: int = 1, d: int = 1, device: str = "cuda", **kw
) -> BatchResult:
    """One-shot batched alignment."""
    return NWAligner(
        AlignConfig(scoring=ScoringParams(m, k, d)), device=device
    ).align_batch(pairs, **kw)

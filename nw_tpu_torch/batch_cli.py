"""Batch CLI: align many pairs from a file on the card.

Counterpart of ``nw_tpu/batch_cli.py`` (``nw-tpu-batch``), with the same
flags and output bytes::

    nw-tpu-torch-batch --pairs pairs.txt --alignments --counts -m 2 -k 1 -d 1
    python -m nw_tpu_torch.batch_cli --pairs pairs.txt --mode affine --alignments

Input: one pair per line, two whitespace-separated sequences.  Output:
TSV to stdout (or --out), one row per input pair in input order::

    index  score  [count]  [X  Y]

``--mode`` picks the model: ``nw`` (global, ``NWAligner.align_batch``),
``sw`` (local, ``sw_align_batch`` / ``sw_score_batch``), ``overlap``
(``overlap_align_batch`` / ``overlap_score_batch``) or ``affine`` (Gotoh,
``affine_align_batch`` / ``affine_score_pairs``).  Pairs are cut into
``--chunk`` pairs a device batch; ``--checkpoint-dir`` makes the run
resumable after preemption (:class:`nw_tpu_torch.runtime.checkpoint.
CheckpointedRunner`: chunks already on disk are skipped, ``--retries``
re-attempts a failing chunk); ``--sort-by-length`` groups pairs of like
length to cut padding (output order stays input order).

``NW_TPU_PLATFORM=cpu`` runs the kernels' plain PyTorch versions; unset
(or ``cuda``) runs on the card, and without one the CLI exits 1.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np


def _read_pairs(stream) -> List[Tuple[bytes, bytes]]:
    pairs = []
    for lineno, raw in enumerate(stream, 1):
        line = raw.strip()
        if not line:
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            raise SystemExit(
                f"line {lineno}: expected two whitespace-separated "
                f"sequences, got {len(parts)}"
            )
        pairs.append((parts[0], parts[1].split(None, 1)[0]))
    return pairs


def _strings(res) -> dict:
    """Scores and fixed-width 'S' string arrays (npz-serializable without
    pickle) of (score, X, Y, ...) rows."""
    return {
        "scores": np.array([r[0] for r in res], np.int32),
        "X": np.array([r[1] for r in res], dtype=np.bytes_),
        "Y": np.array([r[2] for r in res], dtype=np.bytes_),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nw-tpu-torch-batch",
        description="Batched Needleman-Wunsch alignment on an NVIDIA card",
    )
    ap.add_argument("--pairs", help="input file (default: stdin)")
    ap.add_argument("--out", help="output TSV (default: stdout)")
    ap.add_argument("-m", type=int, default=1, help="match bonus")
    ap.add_argument("-k", type=int, default=1, help="mismatch penalty")
    ap.add_argument("-d", type=int, default=1, help="indel penalty")
    ap.add_argument("--mode", choices=("nw", "sw", "overlap", "affine"), default="nw",
                    help="global (nw), local (sw), semi-global (overlap), "
                    "or affine-gap global alignment")
    ap.add_argument("--open", type=int, default=3, dest="gap_open",
                    help="affine gap-open cost (--mode affine)")
    ap.add_argument("--extend", type=int, default=1, dest="gap_extend",
                    help="affine gap-extend cost (--mode affine)")
    ap.add_argument("--counts", action="store_true",
                    help="emit optimal-alignment counts (mod 2^32; nw only)")
    ap.add_argument("--alignments", action="store_true",
                    help="emit one optimal alignment per pair")
    ap.add_argument("--chunk", type=int, default=2048, help="pairs per device batch")
    ap.add_argument("--checkpoint-dir", help="persist per-chunk results; reruns resume")
    ap.add_argument("--retries", type=int, default=0,
                    help="re-attempts per failing chunk (with --checkpoint-dir)")
    ap.add_argument("--sort-by-length", action="store_true",
                    help="bucket-sort pairs to reduce padding waste")
    args = ap.parse_args(argv)

    from nw_tpu_torch import cli
    from nw_tpu_torch.config import AlignConfig, ScoringParams
    from nw_tpu_torch.models import affine, overlap, smith_waterman
    from nw_tpu_torch.models.needleman_wunsch import NWAligner

    src = open(args.pairs, "rb") if args.pairs else sys.stdin.buffer
    try:
        pairs = _read_pairs(src)
    finally:
        if args.pairs:
            src.close()

    order = np.arange(len(pairs))
    if args.sort_by_length:
        key = np.array([max(len(a), len(b)) for a, b in pairs])
        order = np.argsort(key, kind="stable")
        pairs = [pairs[i] for i in order]

    if args.counts and args.mode != "nw":
        raise SystemExit("--counts is only defined for --mode nw")

    try:
        dev = cli._device(sys.stderr.buffer, "nw-tpu-torch-batch")
    except cli._Exit as e:
        return e.code
    al = NWAligner(AlignConfig(scoring=ScoringParams(args.m, args.k, args.d)), device=dev)
    mkd = (args.m, args.k, args.d)
    gotoh = (args.m, args.k, args.gap_open, args.gap_extend)

    def align_chunk(chunk):
        if args.mode == "sw":
            if args.alignments:
                return _strings(smith_waterman.sw_align_batch(chunk, *mkd, device=dev))
            return {"scores": smith_waterman.sw_score_batch(chunk, *mkd, device=dev)}
        if args.mode == "overlap":
            if args.alignments:
                return _strings(overlap.overlap_align_batch(chunk, *mkd, device=dev))
            return {"scores": overlap.overlap_score_batch(chunk, *mkd, device=dev)}
        if args.mode == "affine":
            if args.alignments:
                return _strings(affine.affine_align_batch(chunk, *gotoh, device=dev))
            return {"scores": affine.affine_score_pairs(chunk, *gotoh, device=dev)}
        r = al.align_batch(chunk, traceback_strings=args.alignments, count=args.counts)
        out = {"scores": r.scores}
        if args.counts:
            out["counts"] = r.counts
        if args.alignments:
            strs = r.alignment_strings()
            out["X"] = np.array([x for x, _ in strs], dtype=np.bytes_)
            out["Y"] = np.array([y for _, y in strs], dtype=np.bytes_)
        return out

    if args.checkpoint_dir:
        from nw_tpu_torch.runtime.checkpoint import CheckpointedRunner

        # key the manifest on everything that shapes chunk results, so
        # resuming with other parameters or flags is rejected instead of
        # silently concatenating stale chunk files
        key = (
            f"mode={args.mode} m={args.m} k={args.k} d={args.d} "
            f"open={args.gap_open} extend={args.gap_extend} "
            f"counts={args.counts} alignments={args.alignments} "
            f"sorted={args.sort_by_length}"
        )
        runner = CheckpointedRunner(args.checkpoint_dir, chunk_size=args.chunk, key=key)
        res = runner.run(pairs, align_chunk, retries=args.retries)
    else:
        parts = [align_chunk(pairs[i : i + args.chunk]) for i in range(0, len(pairs), args.chunk)]
        res = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]} if parts else {}

    # undo the length sort: emit rows in input order
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))

    dst = open(args.out, "w") if args.out else sys.stdout
    try:
        for i in range(len(pairs)):
            j = inv[i] if args.sort_by_length else i
            row = [str(i), str(int(res["scores"][j]))]
            if args.counts:
                row.append(str(int(res["counts"][j]) % 2**32))
            if args.alignments:
                x, y = res["X"][j], res["Y"][j]
                row.append(x.decode("latin-1") if isinstance(x, bytes) else str(x))
                row.append(y.decode("latin-1") if isinstance(y, bytes) else str(y))
            dst.write("\t".join(row) + "\n")
    finally:
        if args.out:
            dst.close()
    return 0


def console_main() -> None:
    from nw_tpu_torch.cli import _quiet_library_logging

    _quiet_library_logging()
    sys.exit(main())


if __name__ == "__main__":
    console_main()

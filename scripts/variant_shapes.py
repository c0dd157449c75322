"""Time the pipeline's variant fills through their public wrappers at
``chip_smoke.py``'s shapes, so that two trees can be compared on one card
in turns: the Smith-Waterman, overlap and Gotoh score fills
(``sw_scores``, ``overlap_scores``, ``gotoh_scores``) at phase 10's
128 x 10 240 bp and 10 240 x 150 bp, and the code fills
(``sw_fill_codes``, ``overlap_fill_codes``, ``gotoh_fill_codes``) at
phase 11's 128 x 3 072 bp and 4 096 x 150 bp.

    python3 scripts/variant_shapes.py [--check] [ROOT]

ROOT (default: this checkout) is the tree whose ``nw_tpu_torch`` is
imported and built; the inputs (random ACGT pairs from phases 10 and
11's seeds) and the timing come from this checkout's ``chip_smoke.py``.
``--check`` first holds ROOT's fills at the rule's W against their plain
versions on phase 9's check pairs: SW and overlap under every scoring of
``SW_SCORINGS`` (the code fills, with the best's cell and ``sw_walk`` on
their codes, at every W of ``PIPE_WARPS`` too), Gotoh (scores, codes and
corner states) under every scoring of ``GOTOH_ALIGN_SCORINGS``.  To compare a change with its parent, unpack
the parent into a git-ignored directory (``git archive HEAD | tar -x -C
build/parent``) and run, in one call on the card: parent, change,
change, parent.  Prints the card's name and power limit, then one JSON
line: {shape: ms} of the kernels (mean device time by CUDA events after a
warm-up), {shape: s} of the model entry points ``sw_score_batch`` /
``overlap_score_batch`` / ``affine_score_pairs`` / ``sw_align_batch`` /
``overlap_align_batch`` / ``affine_align_batch`` on the same pairs, host
to host (median of 3 warm runs, chip_smoke.py phases 9-11's walls).
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
GOTOH = (2, 1, 3, 1)  # chip_smoke.py phases 10-11's Gotoh scoring


def wall(fn, pairs, sc) -> float:
    """Median of 3 warm host-to-host runs of ``fn(pairs, *sc)``."""
    runs = []
    for _ in range(4):  # a warm-up, then 3 timed
        t0 = time.perf_counter()
        fn(pairs, *sc)
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs[1:])


def main(argv) -> int:
    check = "--check" in argv
    args = [a for a in argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))  # root's nw_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from nw_tpu_torch.models import affine as af
    from nw_tpu_torch.models import overlap as ov
    from nw_tpu_torch.models import smith_waterman as sw
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops import variants_banded as vb

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    kinds = ("sw", "overlap")
    if check:
        pairs = cs.variant_pairs(10, [cs.OVERLAP_TWO_BANDS, *cs.EDGE])
        T = enc.upload(enc.encode_batch(pairs, max(len(a) for a, _ in pairs),
                                        max(len(b) for _, b in pairs)), dev)
        errs = {kind: max(cs.max_abs_err(getattr(vb, f"{kind}_scores_banded_batch")(*T, *mkd),
                                         getattr(vb, f"{kind}_scores_banded_batch_plain")(*T, *mkd))
                          for mkd in cs.SW_SCORINGS) for kind in kinds}
        for kind in kinds:
            e = 0
            for mkd in cs.SW_SCORINGS:
                want = getattr(vb, f"{kind}_fill_codes_banded_batch_plain")(*T, *mkd)
                walk = tb.walk_sw_codes_batch_plain(want[0], want[2], want[3])
                for W in (None, *cs.PIPE_WARPS):
                    got = cs.pipe_fill(f"{kind}_codes", T, mkd, W)
                    got_walk = tb.walk_sw_codes_batch(got[0], got[2], got[3])
                    e = max(e, *(cs.max_abs_err(g, w) for g, w in zip((*got, *got_walk), (*want, *walk))))
            errs[f"{kind}_codes"] = e
        errs["gotoh"] = max(
            max(cs.max_abs_err(vb.affine_scores_banded_batch(*T, *sc), vb.affine_scores_banded_batch_plain(*T, *sc)),
                *(cs.max_abs_err(g, w) for g, w in zip(vb.affine_fill_codes_banded_batch(*T, *sc),
                                                       vb.affine_fill_codes_banded_batch_plain(*T, *sc))))
            for sc in cs.GOTOH_ALIGN_SCORINGS)
        print(f"{len(pairs)} pairs vs plain under {len(cs.SW_SCORINGS)} / {len(cs.GOTOH_ALIGN_SCORINGS)} "
              f"scorings: max |diff| {errs}")
        if any(errs.values()):
            print("FAIL: a fill differs from its plain version", file=sys.stderr)
            return 1
    rng10, rng11 = np.random.default_rng(13), np.random.default_rng(14)  # phases 10 and 11's pairs
    long_pairs = cs.rand_pairs(rng10, 128, cs.L_LONG, cs.L_LONG)
    shapes = {  # label: (pairs, reps, score fills or the code fill)
        f"128x{cs.L_LONG}bp": (long_pairs, 3, True),
        f"10240x{cs.L_SHORT}bp": (cs.rand_pairs(rng10, 10240, cs.L_SHORT, cs.L_SHORT), 20, True),
        f"128x{cs.L_SW_TB}bp": (cs.rand_pairs(rng11, 128, cs.L_SW_TB, cs.L_SW_TB), 3, False),
        f"4096x{cs.L_SHORT}bp": (cs.rand_pairs(rng11, 4096, cs.L_SHORT, cs.L_SHORT), 20, False),
    }
    out, walls = {}, {}
    for label, (pairs, reps, scores) in shapes.items():
        L = len(pairs[0][0])
        T = enc.upload(enc.encode_batch(pairs, L, L), dev)
        if scores:
            for kind in kinds:
                fn = getattr(vb, f"{kind}_scores_banded_batch")
                out[f"{kind}_scores {label}"] = cs.cuda_ms(lambda: fn(*T, 2, 1, 1), reps)
            out[f"gotoh_scores {label}"] = cs.cuda_ms(lambda: vb.affine_scores_banded_batch(*T, *GOTOH), reps)
        else:
            for kind in kinds:
                fn = getattr(vb, f"{kind}_fill_codes_banded_batch")
                out[f"{kind}_fill_codes {label}"] = cs.cuda_ms(lambda: fn(*T, 2, 1, 1), reps)
            out[f"gotoh_fill_codes {label}"] = cs.cuda_ms(lambda: vb.affine_fill_codes_banded_batch(*T, *GOTOH), reps)
        del T
        models = ((("sw_score_batch", sw.sw_score_batch, (2, 1, 1)),
                   ("overlap_score_batch", ov.overlap_score_batch, (2, 1, 1)),
                   ("affine_score_pairs", af.affine_score_pairs, GOTOH)) if scores
                  else (("sw_align_batch", sw.sw_align_batch, (2, 1, 1)),
                        ("overlap_align_batch", ov.overlap_align_batch, (2, 1, 1)),
                        ("affine_align_batch", af.affine_align_batch, GOTOH)))
        for name, model, sc in models:
            walls[f"{name} {label}"] = wall(model, pairs, sc)
    print(json.dumps({"root": str(root), "package": str(Path(vb.__file__).parent.parent),
                      "ms": out, "walls_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

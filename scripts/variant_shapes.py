"""Time the Smith-Waterman and overlap score fills (``sw_scores``,
``overlap_scores``) through their public wrappers at ``chip_smoke.py``'s
phase-9 / phase-10 shapes, 128 x 10 240 bp and 10 240 x 150 bp, so that
two trees can be compared on one card in turns.

    python3 scripts/variant_shapes.py [--check] [ROOT]

ROOT (default: this checkout) is the tree whose ``nw_tpu_torch`` is
imported and built; the inputs (random ACGT pairs from phase 10's seed)
and the timing come from this checkout's ``chip_smoke.py``.
``--check`` first holds ROOT's two score fills at the rule's W against
their plain versions on phase 9's check pairs under every scoring of
``SW_SCORINGS``.  To compare a change with its parent, unpack the parent
into a git-ignored directory (``git archive HEAD | tar -x -C
build/parent``) and run, in one call on the card: parent, change,
change, parent.  Prints the card's name and power limit, then one JSON
line: {shape: ms} of the kernels (mean device time by CUDA events after a
warm-up) and {shape: s} of the model entry points ``sw_score_batch`` /
``overlap_score_batch`` on the same pairs, host to host (median of 3
warm runs, chip_smoke.py phases 9 and 10's walls).
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


def main(argv) -> int:
    check = "--check" in argv
    args = [a for a in argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))  # root's nw_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from nw_tpu_torch.models import overlap as ov
    from nw_tpu_torch.models import smith_waterman as sw
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import variants_banded as vb
    from nw_tpu_torch.runtime import kernels

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    kinds = ("sw", "overlap")
    if check:
        pairs = cs.variant_pairs(10, [cs.OVERLAP_TWO_BANDS])
        T = enc.upload(enc.encode_batch(pairs, max(len(a) for a, _ in pairs),
                                        max(len(b) for _, b in pairs)), dev)
        errs = {kind: max(cs.max_abs_err(getattr(vb, f"{kind}_scores_banded_batch")(*T, *mkd),
                                         getattr(vb, f"{kind}_scores_banded_batch_plain")(*T, *mkd))
                          for mkd in cs.SW_SCORINGS) for kind in kinds}
        print(f"{len(pairs)} pairs vs plain under {len(cs.SW_SCORINGS)} scorings: max |diff| {errs}")
        if any(errs.values()):
            print("FAIL: a score fill differs from its plain version", file=sys.stderr)
            return 1
    rng = np.random.default_rng(13)  # phase 10's pairs
    shapes = {f"128x{cs.L_LONG}bp": (cs.rand_pairs(rng, 128, cs.L_LONG, cs.L_LONG), 3),
              f"10240x{cs.L_SHORT}bp": (cs.rand_pairs(rng, 10240, cs.L_SHORT, cs.L_SHORT), 20)}
    out, walls = {}, {}
    for label, (pairs, reps) in shapes.items():
        L = len(pairs[0][0])
        T = enc.upload(enc.encode_batch(pairs, L, L), dev)
        for kind in kinds:
            fn = getattr(vb, f"{kind}_scores_banded_batch")
            out[f"{kind}_scores {label}"] = cs.cuda_ms(lambda: fn(*T, 2, 1, 1), reps)
        del T
        for name, model in (("sw_score_batch", sw.sw_score_batch), ("overlap_score_batch", ov.overlap_score_batch)):
            runs = []
            for _ in range(4):  # a warm-up, then 3 timed
                t0 = time.perf_counter()
                model(pairs, 2, 1, 1)
                runs.append(time.perf_counter() - t0)
            walls[f"{name} {label}"] = statistics.median(runs[1:])
    print(json.dumps({"root": str(root), "package": str(Path(vb.__file__).parent.parent),
                      "ms": out, "walls_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

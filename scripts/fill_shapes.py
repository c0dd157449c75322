"""Time the batched fills (``nw_scores``, ``nw_fill_codes``) through
their public wrappers at ``chip_smoke.py``'s phase-5 shapes, so that two
trees can be compared on one card in turns.

    python3 scripts/fill_shapes.py [--check] [--sweep] [ROOT]

ROOT (default: this checkout) is the tree whose ``nw_tpu_torch`` is
imported and built; the inputs and the timing come from this checkout's
``chip_smoke.py``.  ``--check`` first holds ROOT's pipeline at every
forced W against its plain versions under every scoring, as
``chip_smoke.py`` phase 3 does, and ``--sweep`` ends with phase 5's
sweep of W (both for a tree with the W-warp pipeline only).  To compare a change with its parent, unpack the
parent into a git-ignored directory (``git archive HEAD | tar -x -C
build/parent``) and run, in one call on the card: parent, change,
change, parent.  Prints the card's name and power limit, then one JSON
line {shape: ms} (mean device time by CUDA events after a warm-up).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    check, sweep = "--check" in argv, "--sweep" in argv
    args = [a for a in argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))  # root's nw_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from nw_tpu_torch import AlignConfig
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    if check:
        small = cs.check_pairs()
        L = AlignConfig().bucket_for(max(len(x) for p in small for x in p))
        errs = {"nw_scores": 0, "nw_fill_codes": 0}
        T = enc.upload(enc.encode_batch(small, L, L), dev)
        for mkd in cs.SCORINGS:
            cs.pipe_vs_plain(T, mkd, errs)
        if any(errs.values()):
            print(f"FAIL: the pipeline differs from its plain versions: {errs}", file=sys.stderr)
            return 1
    c3, c2 = cs.config_pairs()
    T3 = enc.upload(enc.encode_batch(c3, cs.L_LONG, cs.L_LONG), dev)
    L2 = AlignConfig().bucket_for(cs.L_SHORT)  # align_batch's bucket, as phase 4 runs config 2
    T2 = enc.upload(enc.encode_batch(c2, L2, L2), dev)
    public = {
        "scores": lambda T: fb.fill_scores_banded_batch(*T, 2, 1, 1),
        "counts": lambda T: fb.fill_scores_counts_banded_batch(*T, 2, 1, 1),
        "codes": lambda T: fb.fill_greedy_counts_banded_batch(*T, 2, 1, 1),
        "codes+counts": lambda T: fb.fill_greedy_counts_banded_batch(*T, 2, 1, 1, with_counts=True),
    }
    shapes = cs.pipe_shapes(T3, T2, cs.k7_inputs(dev))
    out = {label: cs.cuda_ms(lambda: public[mode](T), reps) for label, mode, T, reps in shapes}
    print(json.dumps({"root": str(root), "package": str(Path(fb.__file__).parent.parent), "ms": out}))
    if sweep:
        cs.pipe_sweep(torch.cuda.get_device_name(0), [shape[:3] for shape in shapes[:2]])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""Time K13's and K6's ports through their public entry points, so that
two trees can be compared on one card in turns.

    python3 scripts/count_shapes.py [ROOT]

ROOT (default: this checkout) is the tree whose ``nw_tpu_torch`` is
imported and built; the inputs come from this checkout's
``chip_smoke.py`` (``rand_pairs``, its seeds).  Times, by CUDA events
(mean after a warm-up): ``count_masks_batch`` at the rule's W over the
tie masks of 4 x 10 240 bp, 128 x 2 048 bp, 1 024 x 256 bp and 10 240 x
150 bp (masks from ``fill_masks_banded_batch``), and
``traceback_checkpointed`` of phase 8's 100 000 bp pair at 1 280-row
blocks (the checkpoint pass, every re-fill and every window walk).  To
compare a change with its parent, unpack the parent into a git-ignored
directory (``git archive HEAD | tar -x -C build/parent``) and run, in
one call on the card: parent, change, change, parent.  Prints the
card's name and power limit, then one JSON line {shape: ms}.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    root = Path(argv[1]).resolve() if len(argv) > 1 else HERE
    sys.path.insert(0, str(root))  # root's nw_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from nw_tpu_torch.ops import checkpoint_traceback as ckt
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import pathcount as pc

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    times = {}
    for nb, L in ((4, cs.L_LONG), (128, 2048), (1024, 256), (10240, cs.L_SHORT)):
        pairs = cs.rand_pairs(np.random.default_rng(nb * L), nb, L, L)
        T = enc.upload(enc.encode_batch(pairs, L, L), dev)
        masks = fb.fill_masks_banded_batch(*T, 2, 1, 1)[0]
        times[f"count {nb}x{L}bp"] = cs.cuda_ms(lambda: pc.count_masks_batch(masks, *T[2:]), 3)
        del masks
    big = cs.rand_pairs(np.random.default_rng(cs.L_HUGE), 1, cs.L_HUGE, cs.L_HUGE)[0]
    top, side = (torch.from_numpy(enc.encode(x)).to(dev) for x in big)
    times[f"traceback_checkpointed 1x{cs.L_HUGE}bp, C = 1280"] = cs.cuda_ms(
        lambda: ckt.traceback_checkpointed(top, side, 2, 1, 1, block_diagonals=1280), 1
    )
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

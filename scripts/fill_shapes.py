"""Time the batched fills (``nw_scores``, ``nw_fill_codes``) through
their public wrappers at ``chip_smoke.py``'s phase-5 shapes, or with
``--bytes`` the byte fills (``nw_fill_masks_batch``,
``nw_fill_runs_batch``) at phases 13-14's, so that two trees can be
compared on one card in turns.

    python3 scripts/fill_shapes.py [--check] [--sweep] [--bytes] [ROOT]

ROOT (default: this checkout) is the tree whose ``nw_tpu_torch`` is
imported and built; the inputs and the timing come from this checkout's
``chip_smoke.py``.  ``--check`` first holds ROOT's pipeline at every
forced W against its plain versions under every scoring, as
``chip_smoke.py`` phase 3 does (with ``--bytes``: the byte fills at every
W of ``BYTE_WARPS`` and the rule's, as phases 13 (a) and 14 (a) do), and
``--sweep`` ends with phase 5's sweep of W (both for a tree with the
W-warp pipeline only; ``--bytes --check`` for a tree whose byte fills
take ``warps=``).  ``--bytes`` times masks with and without counts at
128 x 2 048 bp, 10 240 x 150 bp, 1 024 x 256 bp (K27's flat shape) and
128 x 10 240 bp, run bytes with and without counts at 128 x 10 240 bp and
with counts at config 3 (256 x 10 240 bp in the runs engine's two
launches), and prints each shape's W where ROOT's rule has one for the
byte fills.  To compare a change with its parent, unpack the
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


def byte_shapes(cs, enc, nwm, dev):
    """(label, kind, with_counts, T, reps) of every shape ``--bytes``
    times: phase 13's fill_arrows_auto batches (128 x 2 048 bp, 10 240 x
    150 bp), K27's flat 1 024 x 256 bp, config 3's first 128 pairs and
    config 3 in the runs engine's sub-batches (T a list of launches)."""
    T = {(nb, L): enc.upload(enc.encode_batch(ps, L, L), dev)
         for _, nb, L, ps in cs.mask_path_batches() if L < cs.L_LONG}
    c3, _ = cs.config_pairs()
    LB = cs.L_LONG
    T3 = enc.upload(enc.encode_batch(c3, LB, LB), dev)
    h = tuple(t[:128] for t in T3)
    sub = nwm.strings_sub_batch(LB, LB, "runs")
    parts = [tuple(t[lo : lo + sub] for t in T3) for lo in range(0, len(c3), sub)]
    T7 = cs.k7_inputs(dev)
    return [
        (f"masks 128x{cs.L_ARROWS}bp", "masks", False, [T[128, cs.L_ARROWS]], 5),
        (f"masks+counts 128x{cs.L_ARROWS}bp", "masks", True, [T[128, cs.L_ARROWS]], 5),
        (f"masks 10240x{cs.L_SHORT}bp", "masks", False, [T[10240, cs.L_SHORT]], 10),
        (f"masks+counts 1024x{cs.L_FLAT}bp (K27)", "masks", True, [T7], 10),
        (f"masks 1024x{cs.L_FLAT}bp (K27)", "masks", False, [T7], 10),
        (f"masks+counts 128x{LB}bp", "masks", True, [h], 1),
        (f"runs+counts 128x{LB}bp", "runs", True, [h], 1),
        (f"runs 128x{LB}bp", "runs", False, [h], 1),
        (f"runs+counts config 3 256x{LB}bp ({len(parts)} launches)", "runs", True, parts, 1),
    ]


def time_bytes(cs, fb, enc, nwm, dev, check):
    """``--bytes``: {label: ms} of the byte fills, and {label: W} where
    ROOT's ``fill_warps`` counts the byte rings (``BYTE_RING``)."""
    import torch

    if check:
        small = cs.check_pairs()
        L = max(max(len(a), len(b)) for a, b in small)
        T = enc.upload(enc.encode_batch(small, L, L), dev)
        for mkd in cs.SCORINGS:
            for kind in ("masks", "runs"):
                want = getattr(fb, f"fill_{kind}_banded_batch_plain")(*T, *mkd, with_counts=True)
                e = cs.bytes_vs_plain(kind, T, mkd, want)
                if e:
                    print(f"FAIL: nw_fill_{kind}_batch differs from plain under {mkd}: {e}", file=sys.stderr)
                    return None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out, warps = {}, {}
    for label, kind, wc, launches, reps in byte_shapes(cs, enc, nwm, dev):
        fill = getattr(fb, f"fill_{kind}_banded_batch")
        out[label] = cs.cuda_ms(lambda: [fill(*T, 2, 1, 1, with_counts=wc) for T in launches], reps)
        try:
            warps[label] = [fb.fill_warps(T[0].shape[0], T[0].shape[1], T[1].shape[1], 8 if wc else 4, sms,
                                          ring=fb.BYTE_RING) for T in launches]
        except AttributeError:  # a tree whose byte fills run one warp a pair
            pass
        torch.cuda.empty_cache()
    return out, warps


def main(argv) -> int:
    check, sweep, bytes_ = "--check" in argv, "--sweep" in argv, "--bytes" in argv
    args = [a for a in argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))  # root's nw_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from nw_tpu_torch import AlignConfig
    from nw_tpu_torch.models import needleman_wunsch as nwm
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    if bytes_:
        res = time_bytes(cs, fb, enc, nwm, dev, check)
        if res is None:
            return 1
        out, warps = res
        print(json.dumps({"root": str(root), "package": str(Path(fb.__file__).parent.parent), "ms": out,
                          "warps": warps}))
        return 0
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

"""Phase 15 of chip_smoke.py alone: the two-pass walk engines
(``nw_fill_span``, ``nw_walk_groups``) and the resumable runners, on the
inputs chip_smoke.py's main() gives that phase (its ``check_pairs`` and
``config_pairs``, and config 3's codes-engine results).  Builds the
kernels first.

    python3 scripts/chip_phase15.py

A quicker turn than the whole smoke run for work on the span fill or the
group walk; it prints the phase's log lines and its kernel records, and
exits non-zero on any mismatch, as chip_smoke.py does.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams  # noqa: E402
from nw_tpu_torch.runtime import kernels  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to run", file=sys.stderr)
        sys.exit(2)
    t0 = time.perf_counter()

    def smi(query, *flags):
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", *flags], capture_output=True,
                              text=True, check=True, timeout=60).stdout.strip()

    card = smi("name,power.limit", "--format=csv,noheader").splitlines()[0]
    clock_mhz = float(smi("clocks.max.sm", "--format=csv,noheader,nounits").split()[0])
    bound = cs.Bound(torch.cuda.get_device_properties(0).multi_processor_count, clock_mhz * 1e6)
    kernels.load()
    bound.smem_cycles = cs.smem_load_cycles()  # the walks' span floor, as phase 2 sets it
    small = cs.check_pairs()
    c3, _ = cs.config_pairs()
    aligner = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    r3 = aligner.align_batch(c3, traceback_strings=True, count=True)
    rec = cs.twopass_phase(card, bound, aligner, small, c3, r3, r3.alignment_strings())
    for name, fields in rec.items():
        print(name, {k: v for k, v in fields.items() if k != "shape"})
    print(f"phase 15 alone: {time.perf_counter() - t0:.1f} s [{card}]")


if __name__ == "__main__":
    main()

"""Phase 16 of chip_smoke.py alone: the variant tracebacks' two-pass route
(``free_fill_span``, ``gotoh_fill_span``, ``sw_walk_groups``,
``gotoh_walk_groups``): the kernels against their plain versions at the
check pairs, the 128 x 3 072 bp batches on both routes, and 2 x 40 960 bp
a model past the code budget.  Builds the kernels first.

    python3 scripts/chip_phase16.py

A quicker turn than the whole smoke run for work on the variant span
fills or group walks; it prints the phase's log lines and its kernel
records, and exits non-zero on any mismatch, as chip_smoke.py does.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
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
    rec = cs.variant_twopass_phase(card, bound)
    for name, fields in rec.items():
        print(name, {k: v for k, v in fields.items() if k not in ("shape", "per_model")})
    print(f"phase 16 alone: {time.perf_counter() - t0:.1f} s [{card}]")


if __name__ == "__main__":
    main()

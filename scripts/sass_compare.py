"""Compare the machine code (SASS) of the kernels of two versions of one
CUDA source of nw_tpu_torch, to show that a change left some
instantiations as they were.

    python3 scripts/sass_compare.py [--steps] [--diff] OLD.cu NEW.cu

Each source is compiled with the package's own nvcc flags
(``nw_tpu_torch/runtime/kernels.py``), from its own directory (for its
includes), and disassembled with ``cuobjdump -sass``.  Kernels are
matched by mangled name, with a template argument written as a bool or
as an int of the same value counted as one (``nw_fill_pipe_kernel<true,
false, false>`` is ``nw_fill_pipe_kernel<1, 0, 0>``), the file's hash in
the anonymous namespace's name left out and, for a template, its
parameter types left out (a kernel given a new last parameter, which
its old instantiations do not read, keeps its key; where two kernels of
one file would share a key, both keep their whole names).  For every kernel of OLD the
script prints IDENTICAL or DIFFERENT (the instruction streams, addresses
and encodings left out) and lists the kernels that only NEW has, each
with its count of SASS instructions.
``--steps`` also prints, for every kernel of NEW, the SASS instructions
between consecutive ``SHFL.UP``s of each unrolled 32-step sweep, a
step's where a step holds one (the score-only fills; with counts a step
holds two, in the Gotoh fills two, with codes three): a run of
``SHFL.UP``s each fewer than 80 instructions after the last, cut into
sweeps of 32 where its length is a multiple of 32 (the compiler lays a
chunk's variants one after another), gives one mean distance a sweep,
and the sweep's local-memory (spill) instructions beside it where it has
any (``+Nlocal``).  ``--diff`` prints, under each DIFFERENT kernel, a
unified diff of its two instruction streams (at most 80 lines).  Exit status 1
when a kernel of OLD is missing from NEW or differs.  Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``).
"""

from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nw_tpu_torch.runtime import kernels  # noqa: E402

# one template argument of a mangled name: L b|i <value> E
TEMPLATE_ARG = re.compile(r"L[bi](\d+)E")
# the anonymous namespace's name carries a hash of the file
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
# a template's name and arguments, before its parameter types
TEMPLATE = re.compile(r"(.+?I(?:L\d+E)+E)E")


def sass(src: Path, tmpdir: str) -> dict:
    """{kernel key: [instruction, ...]} of one source."""
    obj = os.path.join(tmpdir, f"{src.stem}-{abs(hash(str(src)))}.o")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-c", "-o", obj, str(src)],
                   check=True, cwd=src.parent)
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    listing = subprocess.run([cuobjdump, "-sass", obj], check=True, capture_output=True, text=True).stdout
    out, name = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = ANON.sub("_GLOBAL__N_", TEMPLATE_ARG.sub(lambda a: f"L{a.group(1)}E", m.group(1)))
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and name:
            out[name].append(re.sub(r"\s+", " ", m.group(1)).strip())
    keys = {name: (TEMPLATE.match(name) or re.match(r"(.*)", name)).group(1) for name in out}
    shared = {k for k in keys.values() if list(keys.values()).count(k) > 1}
    return {(name if keys[name] in shared else keys[name]): code for name, code in out.items()}


def opcode(ins: str) -> str:
    """An instruction's opcode, past its predicate."""
    return ins.split()[1 if ins.startswith("@") else 0]


def sweep_steps(code) -> list:
    """Instructions a step of each unrolled sweep of a kernel's listing,
    and beside each sweep (as ``+Nlocal``) its local-memory (spill)
    loads and stores, where it has any."""
    at = [i for i, ins in enumerate(code) if opcode(ins).startswith("SHFL.UP")]
    runs, run = [], at[:1]
    for i in at[1:]:
        if i - run[-1] < 80:
            run.append(i)
        else:
            runs.append(run)
            run = [i]
    runs.append(run)
    sweeps = []
    for r in runs:
        if len(r) % 32 == 0:
            sweeps += [r[i : i + 32] for i in range(0, len(r), 32)]
        elif len(r) >= 16:
            sweeps.append(r)
    out = []
    for r in sweeps:
        step = round((r[-1] - r[0]) / (len(r) - 1), 1)
        local = sum(opcode(ins).startswith(("LDL", "STL")) for ins in code[r[0] : r[-1] + 1])
        out.append(f"{step}+{local}local" if local else step)
    return out


def main(argv) -> int:
    steps = "--steps" in argv
    diff = "--diff" in argv
    paths = [a for a in argv[1:] if a not in ("--steps", "--diff")]
    if len(paths) != 2:
        print(__doc__)
        return 2
    old, new = (Path(p).resolve() for p in paths)
    with tempfile.TemporaryDirectory() as tmpdir:
        a, b = sass(old, tmpdir), sass(new, tmpdir)
    same = True
    for name, code in sorted(a.items()):
        verdict = "MISSING" if name not in b else ("IDENTICAL" if b[name] == code else "DIFFERENT")
        same &= verdict == "IDENTICAL"
        print(f"{verdict} {name} ({len(code)} -> {len(b.get(name, []))} instructions)")
        if diff and verdict == "DIFFERENT":
            print("\n".join(list(difflib.unified_diff(code, b[name], "old", "new", lineterm=""))[:80]))
        if steps:
            print(f"  steps: old {sweep_steps(code)} new {sweep_steps(b.get(name, []))}")
    for name in sorted(set(b) - set(a)):
        print(f"NEW ONLY {name} ({len(b[name])} instructions)")
        if steps:
            print(f"  steps: {sweep_steps(b[name])}")
    print("SASS_SAME" if same else "SASS_DIFFERS")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))

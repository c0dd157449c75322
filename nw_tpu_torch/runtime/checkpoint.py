"""Checkpoint and resume for long batch runs.

Counterpart of ``nw_tpu/runtime/checkpoint.py:1-118``
(:class:`CheckpointedRunner`; the three ``Resumable*`` runners of that
module are not ported yet).  A multi-hour batch alignment must survive
preemption: the runner splits a pair batch into chunks, persists each
chunk's results (scores, counts, alignment strings) as
``chunk_XXXXX.npz`` next to a manifest, and on restart skips chunks whose
files already exist, so a re-run after preemption costs only the
in-flight chunk.

Files are written atomically (tmp + rename), so a chunk file either
exists complete or not at all.  Host code only: json and numpy.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Sequence, Tuple

import numpy as np


class CheckpointedRunner:
    def __init__(self, directory: str, chunk_size: int = 1024, key: str = ""):
        """``key`` identifies the computation (scoring, mode, flags).  It
        is stored in the manifest and checked on resume, so a directory of
        chunk files from a *different* computation is rejected instead of
        silently concatenated into mixed results."""
        self.directory = directory
        self.chunk_size = chunk_size
        self.key = key
        os.makedirs(directory, exist_ok=True)

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self.directory, f"chunk_{idx:05d}.npz")

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def run(
        self,
        pairs: Sequence[Tuple[bytes, bytes]],
        align_chunk: Callable[[Sequence[Tuple[bytes, bytes]]], Dict[str, np.ndarray]],
        retries: int = 0,
    ) -> Dict[str, np.ndarray]:
        """Run ``align_chunk`` over chunks, resuming from existing files.

        align_chunk: maps a list of pairs to a dict of equal-length
        arrays (e.g. {"scores": ...}).  Returns the concatenated dict.
        retries: re-attempt a failing chunk this many times before
        propagating (a transient device or runtime failure requeues the
        chunk instead of losing the run; completed chunks are never
        recomputed either way).
        """
        n = len(pairs)
        nchunks = -(-n // self.chunk_size) if n else 0
        manifest = {
            "total_pairs": n,
            "chunk_size": self.chunk_size,
            "num_chunks": nchunks,
            "key": self.key,
        }
        mpath = self._manifest_path()
        if os.path.exists(mpath):
            with open(mpath) as f:
                old = json.load(f)
            if (old["total_pairs"], old["chunk_size"], old.get("key", "")) != (
                n, self.chunk_size, self.key,
            ):
                raise ValueError(
                    f"checkpoint dir {self.directory} was written by a "
                    f"different run shape/computation: {old}"
                )
        else:
            tmp = mpath + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, mpath)

        results = []
        for c in range(nchunks):
            path = self._chunk_path(c)
            if os.path.exists(path):
                with np.load(path) as saved:
                    results.append(dict(saved))
                continue
            chunk = pairs[c * self.chunk_size : (c + 1) * self.chunk_size]
            attempt = 0
            while True:
                try:
                    out = align_chunk(chunk)
                    break
                except Exception:
                    attempt += 1
                    if attempt > retries:
                        raise
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **out)
            os.replace(tmp, path)
            results.append({k: np.asarray(v) for k, v in out.items()})

        if not results:
            return {}
        keys = results[0].keys()
        return {k: np.concatenate([r[k] for r in results]) for k in keys}

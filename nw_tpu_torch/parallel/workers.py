"""Ranks as child processes of one caller.

:class:`RankGroup` starts ``world_size`` Python processes on this host,
each one rank of a ``torch.distributed`` group on a 1-D mesh, and runs
the same call on every rank — what ``torchrun`` does for a script, kept
alive across many calls so that a test module or ``chip_smoke.py`` pays
for the start-up once::

    with RankGroup(2, backend="gloo", device="cpu") as ranks:
        results = ranks.run(huge_pair_align_sharded,
                            top, side, 2, 1, 1, MESH, axis="seq", device="cpu")

A call's function goes by pickle (a function of ``nw_tpu_torch``, or a
bound method of one of its objects); the placeholder :data:`MESH` among
its arguments stands for the rank's mesh, and :class:`PerRank` ``([a0,
a1, ...])`` gives rank r the argument ``a_r``.  The children import
``nw_tpu_torch`` and nothing else of this repository.
Every wait on a child has a time limit: a child that fails, dies or
hangs fails the call, and the group is shut down.  With
``device="cuda"`` the kernel library is built in the caller first, so
the ranks never race to build it.

A child: ``python -m nw_tpu_torch.parallel.workers RANK WORLD ADDRESS
BACKEND DEVICE AXIS``.  It reads length-prefixed pickles of
``(function, args, kwargs)`` from its standard input and writes
``("ok", result, seconds, peak_bytes)`` or ``("error", traceback)``
back on the standard output it was started with (anything it prints
goes to its standard error).  ``peak_bytes`` is the card's peak memory
allocated during the call, 0 on the CPU.
"""

from __future__ import annotations

import importlib
import os
import pickle
import queue
import socket
import struct
import subprocess
import sys
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, List

MESH = "<rank mesh>"  # stands for the rank's mesh in a call's arguments
_REPO = Path(__file__).resolve().parents[2]


class PerRank(list):
    """A call's argument that differs by rank: rank r gets item r."""


def _for_rank(x, rank: int):
    if isinstance(x, PerRank):
        return x[rank]
    if isinstance(x, (list, tuple)):
        return type(x)(_for_rank(v, rank) for v in x)
    if isinstance(x, dict):
        return {key: _for_rank(v, rank) for key, v in x.items()}
    return x


def _write(stream, obj) -> None:
    data = pickle.dumps(obj)
    stream.write(struct.pack("<Q", len(data)) + data)
    stream.flush()


def _kill(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _read(stream):
    head = stream.read(8)
    if len(head) < 8:
        raise EOFError("the other side closed the pipe")
    (n,) = struct.unpack("<Q", head)
    data = stream.read(n)
    if len(data) < n:
        raise EOFError("the other side closed the pipe mid-message")
    return pickle.loads(data)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankGroupError(RuntimeError):
    """A rank failed, died or did not answer in time."""


class RankGroup:
    """``world_size`` ranks on this host, one child process each, joined
    over ``backend`` on a 1-D mesh named ``axis``; ``device`` ``"cuda"``
    (every rank on this host's cards: card ``rank`` under NCCL, which
    needs a card a rank; card ``rank % cards`` under gloo) or ``"cpu"``."""

    def __init__(self, world_size: int, backend: str = "gloo", device: str = "cpu",
                 axis: str = "seq", timeout: float = 300.0):
        if device == "cuda":
            from nw_tpu_torch.runtime import kernels

            kernels.build()
        self.world_size = world_size
        address = f"127.0.0.1:{_free_port()}"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        )
        env["LOCAL_WORLD_SIZE"] = str(world_size)
        self._procs: List[subprocess.Popen] = []
        self._replies: List[queue.Queue] = []
        for rank in range(world_size):
            # cwd: "-m" puts it first on the path, so a rank imports this
            # tree's nw_tpu_torch whatever directory its caller runs in
            proc = subprocess.Popen(
                [sys.executable, "-m", "nw_tpu_torch.parallel.workers", str(rank),
                 str(world_size), address, backend, device, axis],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=dict(env, LOCAL_RANK=str(rank)),
                cwd=str(_REPO),
            )
            replies: queue.Queue = queue.Queue()
            threading.Thread(target=self._pump, args=(proc, replies), daemon=True).start()
            self._procs.append(proc)
            self._replies.append(replies)
        weakref.finalize(self, _kill, list(self._procs))  # no rank outlives its caller
        self._collect("start", timeout)

    @staticmethod
    def _pump(proc, replies) -> None:
        try:
            while True:
                replies.put(_read(proc.stdout))
        except Exception as exc:  # EOF: the child is gone
            replies.put(("error", f"the rank's process ended ({exc}); exit code {proc.poll()}"))

    def _collect(self, what: str, timeout: float) -> List[Any]:
        deadline = time.monotonic() + timeout
        out = []
        for rank, replies in enumerate(self._replies):
            try:
                reply = replies.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                self.close(kill=True)
                raise RankGroupError(f"rank {rank} did not answer {what} within {timeout} s")
            if reply[0] != "ok":
                self.close(kill=True)
                raise RankGroupError(f"rank {rank} failed {what}:\n{reply[1]}")
            out.append(reply)
        return out

    def run_timed(self, fn: Callable, *args, timeout: float = 600.0, **kwargs) -> List[tuple]:
        """Run ``fn(*args, **kwargs)`` on every rank; returns each rank's
        ``(result, seconds, peak_bytes)``, rank order."""
        for rank, proc in enumerate(self._procs):
            _write(proc.stdin, (fn, _for_rank(args, rank), _for_rank(kwargs, rank)))
        return [tuple(r[1:]) for r in self._collect(getattr(fn, "__name__", "the call"), timeout)]

    def run(self, fn: Callable, *args, timeout: float = 600.0, **kwargs) -> List[Any]:
        """Run ``fn(*args, **kwargs)`` on every rank; returns each rank's
        result, rank order."""
        return [r[0] for r in self.run_timed(fn, *args, timeout=timeout, **kwargs)]

    def close(self, kill: bool = False, timeout: float = 60.0) -> None:
        """Stop every rank (at once with ``kill``)."""
        for proc in self._procs:
            if proc.poll() is None and not kill:
                try:
                    _write(proc.stdin, None)
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for proc in self._procs:
            try:
                if kill:
                    raise subprocess.TimeoutExpired(proc.args, 0)
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._procs = []

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def launch_counts(counters, reset: bool = False) -> List[int]:
    """The launch counters ``counters`` — (module, wrapper, attribute)
    names, e.g. ``("nw_tpu_torch.ops.fill_single", "fill_tile",
    "launches")`` — of the process that runs this (a rank, through
    :meth:`RankGroup.run`), set to 0 after reading with ``reset``."""
    out = []
    for module, wrapper, attr in counters:
        fn = getattr(importlib.import_module(module), wrapper)
        out.append(getattr(fn, attr))
        if reset:
            setattr(fn, attr, 0)
    return out


def _swap_mesh(x, mesh):
    if isinstance(x, str) and x == MESH:
        return mesh
    if isinstance(x, (list, tuple)):
        return type(x)(_swap_mesh(v, mesh) for v in x)
    if isinstance(x, dict):
        return {key: _swap_mesh(v, mesh) for key, v in x.items()}
    return x


def _serve(rank: int, world: int, address: str, backend: str, device: str, axis: str) -> None:
    proto_out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)  # prints go to stderr, replies to the saved stdout
    sys.stdout = sys.stderr
    proto_in = sys.stdin.buffer
    try:
        import torch
        import torch.distributed as dist

        from nw_tpu_torch.parallel.distributed import init_distributed
        from nw_tpu_torch.parallel.mesh import make_mesh

        init_distributed(backend, address, world, rank, device=device)
        mesh = make_mesh((world,), (axis,), device_type=device)
    except Exception:
        _write(proto_out, ("error", traceback.format_exc()))
        return
    _write(proto_out, ("ok", None, 0.0, 0))
    cuda = device == "cuda"
    while True:
        job = _read(proto_in)
        if job is None:
            break
        fn, args, kwargs = job
        try:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = fn(*_swap_mesh(args, mesh), **_swap_mesh(kwargs, mesh))
            if cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            _write(proto_out, ("ok", result, seconds, peak))
        except Exception:
            _write(proto_out, ("error", traceback.format_exc()))
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, addr, be, dev, ax = sys.argv[1:7]
    _serve(int(r), int(w), addr, be, dev, ax)

"""Host-side sequence encoding, padding and upload.

Same arrays and functions as ``nw_tpu/ops/encode.py`` (``encode``,
``decode``, ``pad_to``, ``encode_pair``, ``encode_batch``,
``encode_batch_u8``), plus :func:`upload`:

* characters are their byte value (0..255);
* the two sequences of a pair are padded with *distinct* sentinels
  (``PAD_TOP = -1``, ``PAD_SIDE = -2``) so a padded top character never
  matches a padded side character.  Cell (j, i) of the DP table reads
  only cells with smaller row and column indices, so the true
  (len2+1, len1+1) rectangle is unaffected by padding, and every output
  (scores, counts, walks) is read inside it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

PAD_TOP = -1
PAD_SIDE = -2


def encode(seq: str | bytes) -> np.ndarray:
    """Encode one sequence as an int32 vector of byte values."""
    if isinstance(seq, str):
        seq = seq.encode("utf-8")
    return np.frombuffer(bytes(seq), dtype=np.uint8).astype(np.int32)


def decode(arr) -> str:
    """Inverse of :func:`encode`: the characters of an int32 vector (numpy
    or a tensor), its pad sentinels dropped."""
    arr = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr)
    return bytes(int(c) for c in arr if c >= 0).decode("utf-8")


def pad_to(arr: np.ndarray, length: int, fill: int) -> np.ndarray:
    """int32[length]: ``arr`` followed by ``fill``; a longer ``arr``
    raises ``ValueError``."""
    if arr.shape[0] > length:
        raise ValueError(f"sequence length {arr.shape[0]} exceeds bucket {length}")
    out = np.full((length,), fill, dtype=np.int32)
    out[: arr.shape[0]] = arr
    return out


def encode_pair(
    s1: str | bytes, s2: str | bytes, len1: int | None = None, len2: int | None = None
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Encode a (top, side) pair padded to (len1, len2), each defaulting
    to its string's length: (top codes, side codes, true len1, true
    len2)."""
    a, b = encode(s1), encode(s2)
    n1, n2 = a.shape[0], b.shape[0]
    return pad_to(a, n1 if len1 is None else len1, PAD_TOP), pad_to(b, n2 if len2 is None else len2, PAD_SIDE), n1, n2


def encode_batch(
    pairs: Sequence[Tuple[str | bytes, str | bytes]],
    len1: int | None = None,
    len2: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Encode a batch of pairs into stacked int32 (B, len1) / (B, len2)
    arrays padded with the sentinels.  Returns (tops, sides, lens1,
    lens2); ``len1``/``len2`` default to the batch maxima."""
    return _encode_batch_impl(
        pairs, len1, len2, fills=(PAD_TOP, PAD_SIDE), dtype=np.int32
    )


def encode_batch_u8(
    pairs: Sequence[Tuple[str | bytes, str | bytes]],
    len1: int | None = None,
    len2: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`encode_batch` with uint8 outputs and a 0 pad.  Sound for
    every output read inside the true rectangle (see the module
    docstring); consumers that read whole tables keep the sentinels."""
    return _encode_batch_impl(pairs, len1, len2, fills=(0, 0), dtype=np.uint8)


def _encode_batch_impl(pairs, len1, len2, fills, dtype):
    raw = [
        (
            a.encode("utf-8") if isinstance(a, str) else bytes(a),
            b.encode("utf-8") if isinstance(b, str) else bytes(b),
        )
        for a, b in pairs
    ]
    lens1 = np.array([len(a) for a, _ in raw], dtype=np.int32)
    lens2 = np.array([len(b) for _, b in raw], dtype=np.int32)
    if len1 is None:
        len1 = int(lens1.max()) if len(raw) else 0
    if len2 is None:
        len2 = int(lens2.max()) if len(raw) else 0
    tops = _scatter_encode([a for a, _ in raw], lens1, len1, fills[0], dtype)
    sides = _scatter_encode([b for _, b in raw], lens2, len2, fills[1], dtype)
    return tops, sides, lens1, lens2


def _scatter_encode(seqs, lens, bucket, fill, dtype):
    """One concatenated buffer and one masked scatter for the batch."""
    if (lens > bucket).any():
        bad = int(np.argmax(lens > bucket))
        raise ValueError(
            f"sequence length {int(lens[bad])} exceeds bucket {bucket}"
        )
    out = np.full((len(seqs), bucket), fill, dtype=dtype)
    if len(seqs) and bucket:
        flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
        mask = np.arange(bucket, dtype=np.int32)[None, :] < lens[:, None]
        out[mask] = flat  # row-major mask order == concatenation order
    return out


def upload(arrays, device) -> Tuple[torch.Tensor, ...]:
    """Copy host arrays to ``device`` as contiguous torch tensors."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays
    )

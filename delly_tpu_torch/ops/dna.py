"""DNA sequence <-> integer array encoding for device kernels."""

from __future__ import annotations

import numpy as np

# Encoding: every distinct byte maps to itself; kernels only need equality
# comparisons, so raw ASCII codes are a valid alphabet. Helper keeps an
# explicit uint8 view plus padding.

PAD = 0  # '\0' never occurs in sequences


def encode(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode(), dtype=np.uint8)


def encode_batch(seqs: list, maxlen: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of sequences into a (B, L) uint8 array + length vector."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(maxlen if maxlen is not None else (lens.max() if len(seqs) else 0))
    out = np.zeros((len(seqs), L), dtype=np.uint8)
    for i, s in enumerate(seqs):
        b = encode(s)[:L]
        out[i, : len(b)] = b
    return out, lens

"""Sequence makers on the device, from one torch.Generator per run.

The models are those of the port's synthetic data
(delly_tpu_torch/testing/synth.py): uniform random bases
(`random_contig` without GC blocks), substitutions that always change
the base (`add_read_errors`), and noisy segments with substitutions and
1-bp insertions and deletions, half each (`noisy_segment`, the model of
`make_lr_genome_dataset`'s ONT reads). Here they run batched in torch,
so that a cell makes its hundreds of MB of inputs in a few large calls.
Bases are the bytes A, C, G, T.
"""

from __future__ import annotations

import numpy as np
import torch

BASES = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def numpy_rng(seed: int, salt: int) -> np.random.Generator:
    """A host generator for a run's orders and draws, apart from the
    device's stream (`salt` separates its uses)."""
    return np.random.default_rng([int(seed) % (1 << 63), salt])


def random_codes(g, shape, device) -> torch.Tensor:
    """Codes 0-3 (int64) of uniform random bases."""
    return torch.randint(0, 4, shape, generator=g, device=device)


def to_bytes(codes: torch.Tensor) -> torch.Tensor:
    return BASES.to(codes.device)[codes]


def substitute(g, codes: torch.Tensor, rate: float) -> torch.Tensor:
    """Codes with each base changed, at `rate`, to one of the other
    three."""
    hit = torch.rand(codes.shape, generator=g, device=codes.device) < rate
    shift = torch.randint(1, 4, codes.shape, generator=g, device=codes.device)
    return torch.where(hit, (codes + shift) % 4, codes)


def noisy_copy(g, codes: torch.Tensor, sub_rate: float, indel_rate: float,
               out_len: int):
    """Noisy copies of template rows (R, T) int64 codes: substitutions
    at `sub_rate`, and at `indel_rate` an interior position that is
    either deleted or followed by one random inserted base (half each).
    Returns (codes (R, out_len) int64, lengths (R,) int64): each copy
    cut to `out_len`, or shorter where its template ran out."""
    dev = codes.device
    R, T = codes.shape
    r = torch.rand(R, T, generator=g, device=dev)
    shift = torch.randint(1, 4, (R, T), generator=g, device=dev)
    base = torch.where(r < sub_rate, (codes + shift) % 4, codes)
    pos = torch.arange(T, device=dev)
    interior = (pos > 0) & (pos < T - 1)
    indel = (r >= sub_rate) & (r < sub_rate + indel_rate) & interior
    ins = indel & (torch.rand(R, T, generator=g, device=dev) < 0.5)
    dele = indel & ~ins
    keep = (~dele).to(torch.int64)
    emit = keep + ins.to(torch.int64)
    start = torch.cumsum(emit, dim=1) - emit
    lens = emit.sum(1).clamp(max=out_len)
    out = torch.zeros(R, out_len + 2, dtype=torch.int64, device=dev)
    extra = torch.randint(0, 4, (R, T), generator=g, device=dev)
    sink = out_len + 1
    row = torch.arange(R, device=dev)[:, None].expand(R, T)
    at = torch.where((keep > 0) & (start < out_len), start, sink)
    out[row, at] = base
    at2 = torch.where(ins & (start + 1 < out_len), start + 1, sink)
    out[row, at2] = extra
    return out[:, :out_len], lens


def quota(weights, total: int) -> np.ndarray:
    """Counts in proportion to `weights` that sum to `total` exactly
    (largest remainder; ties to the earlier entry): every seed gets the
    same counts."""
    w = np.asarray(weights, dtype=np.float64)
    exact = w / w.sum() * total
    base = np.floor(exact).astype(np.int64)
    rest = total - int(base.sum())
    order = np.argsort(-(exact - base), kind="stable")
    base[order[:rest]] += 1
    return base

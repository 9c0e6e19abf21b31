"""Junction-alignment batches of short-read genotyping: delly's
(probe, read) pairs (coverage.h:412-454; the port's
models/genotype_sr.py `_process_jobs_device`), two pairs a job.

Each job takes a fresh random locus with a deletion: left flank,
deleted segment, right flank. The ALT probe is the ALT haplotype
(left + right) centred on its junction, the REF probe the REF
haplotype centred on the left breakpoint, at the lengths of the cell's
frozen histogram. The read is a window of the read length from the ALT
or the REF haplotype (half each) that spans its junction by at least 10
bases on each side, with substitutions at the configuration's rate.
Pairs go (ALT probe, read), (REF probe, read) job by job, padded as the
port's `batched_pairs_distance` pads them (ops/edist.py `bucket_q`,
`bucket_t`).
"""

from __future__ import annotations

import numpy as np
import torch

from svbench.gen import dna


def bucket_q(x: int) -> int:
    """The port's query padding: word multiples up to 512, powers of
    two above."""
    if x <= 512:
        return max(32, -(-x // 32) * 32)
    b = 1024
    while b < x:
        b *= 2
    return b


def bucket_t(x: int) -> int:
    """The port's target padding: powers of two from 128."""
    b = 128
    while b < x:
        b *= 2
    return b


def job_lengths(hist, jobs: int, rng) -> np.ndarray:
    """(jobs, 3) int64 (ALT probe, REF probe, read) lengths: the
    histogram's rows [alt, ref, read, count] in exact proportion, in an
    order drawn from `rng`."""
    rows = np.asarray([r[:3] for r in hist], dtype=np.int64)
    counts = dna.quota([r[3] for r in hist], jobs)
    out = np.repeat(rows, counts, axis=0)
    return out[rng.permutation(len(out))]


def _window(hap, start, length, width):
    """Codes hap[j, start_j : start_j + length_j], -1 past each length,
    in rows of `width`."""
    k = torch.arange(width, device=hap.device)[None, :]
    idx = (start[:, None] + k).clamp(max=hap.shape[1] - 1)
    return torch.where(k < length[:, None], hap.gather(1, idx), -1)


def _bytes(codes):
    """Codes to bases, -1 to the padding byte 0."""
    return torch.where(codes >= 0, dna.to_bytes(codes.clamp(min=0)),
                       0).to(torch.uint8)


def make(cell: dict, config: dict, seed: int, device) -> list:
    """The cell's pool: a list of batches, each a dict of device tensors
    q, ql, t, tl and the host lengths qlens, tlens."""
    g = dna.generator(seed, device)
    jobs = int(cell["jobs_per_batch"])
    sub = float(config["read_substitution_rate"])
    pool = []
    for b in range(int(cell["pool_batches"])):
        lens = job_lengths(cell["frozen"]["junction_jobs"], jobs,
                           dna.numpy_rng(seed, b))
        alt_l, ref_l, read_l = (torch.from_numpy(lens[:, k]).to(device)
                                for k in range(3))
        F = int(max(128, lens.max()))
        left, gone, right = (dna.random_codes(g, (jobs, F), device)
                             for _ in range(3))
        alt_hap = torch.cat([left, right, torch.zeros_like(left)], 1)
        ref_hap = torch.cat([left, gone, right], 1)
        M = bucket_q(int(max(lens[:, 0].max(), lens[:, 1].max())))
        N = bucket_t(int(lens[:, 2].max()))
        alt_p = _bytes(_window(alt_hap, F - alt_l // 2, alt_l, M))
        ref_p = _bytes(_window(ref_hap, F - ref_l // 2, ref_l, M))
        span = (read_l - 20).clamp(min=1)
        off = 10 + (torch.rand(jobs, generator=g, device=device)
                    * span).to(torch.int64)
        from_alt = torch.rand(jobs, generator=g, device=device) < 0.5
        hap = torch.where(from_alt[:, None], alt_hap, ref_hap)
        codes = _window(hap, F - off, read_l, N)
        read = _bytes(torch.where(codes >= 0,
                                  dna.substitute(g, codes.clamp(min=0), sub),
                                  -1))
        q = torch.stack([alt_p, ref_p], 1).reshape(2 * jobs, M)
        t = read.repeat_interleave(2, 0)
        ql = torch.stack([alt_l, ref_l], 1).reshape(-1).to(torch.int32)
        tl = read_l.repeat_interleave(2).to(torch.int32)
        qlens = np.stack([lens[:, 0], lens[:, 1]], 1).reshape(-1)
        tlens = np.repeat(lens[:, 2], 2)
        pool.append({"q": q.contiguous(), "ql": ql.contiguous(),
                     "t": t.contiguous(), "tl": tl.contiguous(),
                     "qlens": qlens.astype(np.int64),
                     "tlens": tlens.astype(np.int64)})
    return pool

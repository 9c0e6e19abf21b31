"""One SV's all-pairs NW distances before its long-read consensus, a
batch: the call that the port's `lr` makes for each SV it assembles
with msaEdlib (models/assemble.py `_run_msa_and_align` -> `msa_edlib`
-> `_all_pairs_nw`: one `batched_pairs_distance` call of the C(n, 2)
pairs among the n read segments that `select_best_reads` keeps).

The cell's frozen `msa_calls` (svbench/gen/freeze_lr.py) give, for each
SV consensus of a run of the port, its type, which MSA takes it, and its
segments' lengths. Only msaEdlib's calls are made here. Insertions take
msaWFA (`sv.svt == 4`), whose one `_all_pairs_nw` call a SV compares
overlap-trimmed substrings whose lengths follow the insertion's size,
so it needs a published size spectrum, which this cell does without:
a deletion's segments are cut around the split point whatever its
size. A pool of `calls` batches holds the frozen calls in their exact
proportions (largest remainder), interleaved in a fixed order, so every
seed gets the same sizes in the same order, with its own bases. A call's segments are noisy copies of
one random haplotype window with the configuration's substitution and
indel rates, each cut to its frozen length; its pairs are all i < j,
padded as `batched_pairs_distance` pads them (`bucket_q`, `bucket_t` of
ops/edist.py). Calls of one padded shape share one tensor on the card,
each a slice of it.
"""

from __future__ import annotations

import numpy as np
import torch

from svbench.gen import dna
from svbench.gen.junction_reads import bucket_q, bucket_t


def edlib_calls(cell: dict) -> list:
    """The frozen msaEdlib calls: [(lengths, count)]."""
    return [(list(r["lengths"]), int(r["count"]))
            for r in cell["frozen"]["msa_calls"] if r["msa"] == "edlib"]


def call_order(cell: dict) -> list:
    """The segment lengths of each of the pool's `calls` calls: every
    frozen call in proportion, each one's copies spread evenly through
    the pool."""
    recs = edlib_calls(cell)
    counts = dna.quota([c for _l, c in recs], int(cell["calls"]))
    slots = [((k + 0.5) / c, r) for r, c in enumerate(counts)
             for k in range(int(c))]
    slots.sort()
    return [recs[r][0] for _pos, r in slots]


def make(cell: dict, config: dict, seed: int, device) -> list:
    """The cell's pool, batches as in junction_reads.make."""
    g = dna.generator(seed, device)
    sub = float(config["read_substitution_rate"])
    indel = float(config["read_indel_rate"])
    calls = call_order(cell)
    S = len(calls)
    R = max(len(c) for c in calls)
    L = max(max(c) for c in calls)
    T = int(L * 1.08) + 64
    seg = np.zeros((S, R), dtype=np.int64)
    for s, c in enumerate(calls):
        seg[s, :len(c)] = c
    tmpl = dna.random_codes(g, (S, T), device)
    reads, lens = dna.noisy_copy(g, tmpl.repeat_interleave(R, 0), sub,
                                 indel, L)
    lens = torch.minimum(lens, torch.from_numpy(seg.reshape(-1)).to(device))
    k = torch.arange(L, device=device)[None, :]
    reads = torch.where(k < lens[:, None], dna.to_bytes(reads), 0)
    lens_h = lens.cpu().numpy()
    qi, ti, shape, span = [], [], [], []
    for s, c in enumerate(calls):
        iu, ju = np.triu_indices(len(c), 1)
        rl = lens_h[s * R:s * R + len(c)]
        shape.append((bucket_q(int(rl[iu].max())),
                      bucket_t(int(rl[ju].max()))))
        span.append(len(iu))
        qi.append(s * R + iu)
        ti.append(s * R + ju)
    pool = [None] * S
    for MN in sorted(set(shape)):
        members = [s for s in range(S) if shape[s] == MN]
        M, N = MN
        q_i = torch.from_numpy(np.concatenate([qi[s] for s in members])
                               ).to(device)
        t_i = torch.from_numpy(np.concatenate([ti[s] for s in members])
                               ).to(device)
        q = torch.zeros(len(q_i), M, dtype=torch.uint8, device=device)
        t = torch.zeros(len(t_i), N, dtype=torch.uint8, device=device)
        q[:, :min(L, M)] = reads[q_i, :M].to(torch.uint8)
        t[:, :min(L, N)] = reads[t_i, :N].to(torch.uint8)
        ql = lens[q_i].to(torch.int32)
        tl = lens[t_i].to(torch.int32)
        ql_h = ql.cpu().numpy().astype(np.int64)
        tl_h = tl.cpu().numpy().astype(np.int64)
        at = 0
        for s in members:
            a, b = at, at + span[s]
            pool[s] = {"q": q[a:b], "ql": ql[a:b], "t": t[a:b],
                       "tl": tl[a:b], "rows": M,
                       "qlens": ql_h[a:b], "tlens": tl_h[a:b]}
            at = b
    return pool

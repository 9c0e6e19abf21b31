"""One chromosome's split-read assembly as a batch: the work that the
port's `sr` sends to the card in its MSA phase (models/sr.py phase 2:
one `lcs_pairs` call, then `msa_batch`'s guide-tree depths), at the
shapes frozen from a run of the port.

The cell's frozen `msa_svs` give, for each SV shape, its split reads'
lengths and, per guide-tree depth, each merge's rows and columns on
both sides. A batch holds `svs` SVs, the shapes in their frozen
proportions (largest remainder), in an order drawn from the seed.

- X1: all read pairs i < j within each SV. An SV's reads are windows of
  one random haplotype at random offsets, with the configuration's
  substitution rate. Pairs are packed in the port's order
  (ops/lcs_cuda.py `schedule`) with the port's letter table
  (`letter_lut`), as `lcs_pairs` packs them.
- K2/K2-tb: each depth's merges, grouped by the port's K bucket
  (ops/gotoh_cuda.py `_bucket_k`). A merge's sides are made from the
  seed rather than from the depth before, so rounds do not wait on host
  merging: a single row is a plain sequence of its columns; a profile
  of several rows has rows of one haplotype with substitutions, leading
  and trailing gaps of up to a fifth of its columns and 2% interior
  gaps. Both sides share the haplotype, the second shifted by up to
  `side_shift` bases (split reads of one junction start up to ~40
  bases apart, make_deep_geno_dataset). The profiles are packed as
  `pack_bucket` packs them (a test holds this packing to it).
"""

from __future__ import annotations

import numpy as np
import torch

from svbench.gen import dna

GAP = ord("-")
MATCH, MISMATCH = 5, -4


def bucket_k(x: int) -> int:
    b = 128
    while b < x:
        b *= 2
    return b


def sv_shapes(cell: dict, rng) -> list:
    """The batch's SV records, frozen shapes in exact proportion."""
    recs = cell["frozen"]["msa_svs"]
    counts = dna.quota([r["count"] for r in recs], int(cell["svs"]))
    out = [r for r, c in zip(recs, counts) for _ in range(c)]
    return [out[k] for k in rng.permutation(len(out))]


def _reads(g, lens_per_sv, sub, device):
    """Read codes (R, L) int64 (-1 past each length) and lengths."""
    lens = np.concatenate([np.asarray(x, dtype=np.int64)
                           for x in lens_per_sv])
    sv = np.repeat(np.arange(len(lens_per_sv)),
                   [len(x) for x in lens_per_sv])
    L = int(lens.max())
    spread = 120
    tmpl = dna.random_codes(g, (len(lens_per_sv), L + spread), device)
    off = torch.randint(0, spread + 1, (len(lens),), generator=g,
                        device=device)
    k = torch.arange(L, device=device)[None, :]
    codes = tmpl[torch.from_numpy(sv).to(device)].gather(1, off[:, None] + k)
    codes = dna.substitute(g, codes, sub)
    lt = torch.from_numpy(lens).to(device)
    return torch.where(k < lt[:, None], codes, -1), lens


def _x1(g, shapes, sub, device) -> dict:
    from delly_tpu_torch.ops.lcs_cuda import letter_lut, schedule

    codes, lens = _reads(g, [s["lengths"] for s in shapes], sub, device)
    pa, pb, at = [], [], 0
    for s in shapes:
        n = len(s["lengths"])
        iu, ju = np.triu_indices(n, 1)
        pa.append(iu + at)
        pb.append(ju + at)
        at += n
    pa, pb = np.concatenate(pa), np.concatenate(pb)
    order, _segs = schedule(lens[pa], lens[pb])
    pa, pb = pa[order], pb[order]
    ia, ib = (torch.from_numpy(x).to(device) for x in (pa, pb))
    a_codes, b_codes = codes[ia], codes[ib]
    a = torch.where(a_codes >= 0, dna.to_bytes(a_codes.clamp(min=0)), 0)
    b = torch.where(b_codes >= 0, dna.to_bytes(b_codes.clamp(min=0)), 0)
    al_h, bl_h = lens[pa].astype(np.int32), lens[pb].astype(np.int32)
    seen = torch.unique(b_codes[b_codes >= 0])
    letters = np.sort(dna.to_bytes(seen).cpu().numpy()).astype(np.uint8)
    lut, nalpha = letter_lut(letters[None, :], np.array([len(letters)]))
    # word steps: rows of a whose letter occurs in b, x ceil(len(b) / 64)
    in_b = torch.zeros(len(pa), 5, dtype=torch.bool, device=device)
    in_b.scatter_(1, (b_codes + 1).clamp(min=0), True)
    rows = in_b.gather(1, (a_codes + 1).clamp(min=0))
    rows = (rows & (a_codes >= 0)).sum(1)
    steps = int((rows.cpu().numpy() * ((bl_h.astype(np.int64) + 63) // 64))
                .sum())
    return {"a": a.to(torch.uint8).contiguous(),
            "al": torch.from_numpy(al_h).to(device),
            "b": b.to(torch.uint8).contiguous(),
            "bl": torch.from_numpy(bl_h).to(device),
            "al_h": al_h, "bl_h": bl_h,
            "lut": torch.from_numpy(lut).to(device), "nalpha": int(nalpha),
            "word_steps": steps}


def _side(g, tmpl, rows, cols, R, K, shift, sub):
    """Alignments (G, R, K) uint8 of one side of a group's merges."""
    dev = tmpl.device
    G = tmpl.shape[0]
    x = torch.arange(K, device=dev)[None, None, :]
    k = torch.arange(R, device=dev)[None, :, None]
    c = cols[:, None, None]
    multi = (rows > 1)[:, None, None]
    span = torch.clamp(cols // 5, min=1)[:, None, None]
    lead = (torch.rand(G, R, 1, generator=g, device=dev) * span).long()
    trail = (torch.rand(G, R, 1, generator=g, device=dev) * span).long()
    lead = torch.where(multi, lead, 0)
    trail = torch.where(multi, trail, 0)
    base = tmpl.gather(1, (x[:, 0] + shift[:, None]).expand(G, K))
    base = dna.substitute(g, base[:, None, :].expand(G, R, K).contiguous(),
                          sub)
    hole = multi & (torch.rand(G, R, K, generator=g, device=dev) < 0.02)
    gap = (x < lead) | (x >= c - trail) | hole
    out = torch.where(gap, GAP, dna.to_bytes(base).to(torch.int64))
    live = (k < rows[:, None, None]) & (x < c)
    return torch.where(live, out, 0).to(torch.uint8)


def pack(a, rows, cols, K):
    """(counts (G, 5, K) of A, C, G, T, N, depth (G, K)) int32 of one
    side, as ops/gotoh.py `profile_counts` counts them."""
    dev = a.device
    code = torch.full((256,), -1, dtype=torch.int64, device=dev)
    for i, ch in enumerate(b"ACGTN-"):
        code[ch] = i
    cls = code[a.to(torch.int64)]                      # (G, R, K)
    R = a.shape[1]
    x = torch.arange(K, device=dev)
    live = ((torch.arange(R, device=dev)[None, :, None] < rows[:, None, None])
            & (x[None, None, :] < cols[:, None, None]))
    letter = (cls >= 0) & (cls != 5) & live
    pos = torch.where(letter, x[None, None, :], -1)
    last = pos.max(2).values
    first = torch.where(letter, x[None, None, :], K).min(2).values
    inside = (x[None, None, :] >= first[:, :, None]) & \
        (x[None, None, :] <= last[:, :, None])
    # a row with no letter covers every column, as a single row does
    whole = (rows == 1)[:, None, None] | ~letter.any(2, keepdim=True)
    inside = torch.where(whole, live, inside & live)
    counts = torch.stack([((cls == i) & inside).sum(1) for i in range(5)],
                         1)
    depth = ((cls >= 0) & inside).sum(1)
    return counts.to(torch.int32), depth.to(torch.int32)


def _group(g, merges, K, sub, shift_max, device) -> dict:
    """One (depth, K) group: raw sides for the reference and the packed
    inputs of K2."""
    arr = np.asarray(merges, dtype=np.int64)          # (G, 4) r1 c1 r2 c2
    G = len(arr)
    r1, c1, r2, c2 = (torch.from_numpy(arr[:, k]).to(device)
                      for k in range(4))
    tmpl = dna.random_codes(g, (G, K + shift_max + 1), device)
    shift = torch.randint(0, shift_max + 1, (G,), generator=g,
                          device=device)
    a1 = _side(g, tmpl, r1, c1, int(arr[:, 0].max()), K,
               torch.zeros_like(shift), sub)
    a2 = _side(g, tmpl, r2, c2, int(arr[:, 2].max()), K, shift, sub)
    cnt1, dep1 = pack(a1, r1, c1, K)
    cnt2, dep2 = pack(a2, r2, c2, K)
    prof = torch.cat([cnt1.transpose(1, 2), dep1[:, :, None]], 2)
    # w @ counts, w = MATCH on the diagonal and MISMATCH elsewhere
    wc2 = (MISMATCH * cnt2.sum(1, keepdim=True)
           + (MATCH - MISMATCH) * cnt2).to(torch.int32)
    return {"a1": a1, "r1": r1, "m": c1, "a2": a2, "r2": r2, "n": c2,
            "K": K, "prof": prof.contiguous(), "wc2": wc2.contiguous(),
            "d2": dep2.contiguous(), "ml": c1.to(torch.int32),
            "nl": c2.to(torch.int32), "m_h": arr[:, 1], "n_h": arr[:, 3],
            "multi": (arr[:, 0] > 1) | (arr[:, 2] > 1)}


def make(cell: dict, config: dict, seed: int, device) -> list:
    """The cell's pool: batches {"x1": ..., "groups": [...]}."""
    g = dna.generator(seed, device)
    sub = float(config["read_substitution_rate"])
    pool = []
    for b in range(int(cell["pool_batches"])):
        shapes = sv_shapes(cell, dna.numpy_rng(seed, 100 + b))
        by: dict = {}
        for s in shapes:
            for depth, merges in enumerate(s["rounds"]):
                for (r1, c1), (r2, c2) in merges:
                    key = (depth, bucket_k(max(c1, c2)))
                    by.setdefault(key, []).append((r1, c1, r2, c2))
        pool.append({"x1": _x1(g, shapes, sub, device),
                     "groups": [dict(_group(g, by[key], key[1], sub,
                                            int(cell["side_shift"]), device),
                                     depth=key[0])
                                for key in sorted(by)]})
    return pool

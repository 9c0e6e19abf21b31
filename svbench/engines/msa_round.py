"""Engine `msa_round`: one chromosome's split-read assembly a batch, at
the device contract of the port's wrappers: `ops/lcs_cuda.py lcs` (X1)
over every read pair, then for each guide-tree depth and K bucket
`ops/gotoh_cuda.py gotoh_forward` (K2) and `gotoh_traceback` (K2-tb),
end gaps free on both sides (msa_batch's merges), delly's default
scores. Every output comes back to pinned host memory: the LCS
lengths, each merge's best score, walk codes and walk length.

The reference checks every LCS length of each kept output
(svbench/reference/lcs.py) and a sample of `check_merges` merges per K
bucket of each pool batch, with the largest, by profile Gotoh and its
walk (svbench/reference/gotoh.py), worked out from the raw alignment
rows. Its control is the same reference confined to a band of
diagonals (the configuration's `control`).
"""

from __future__ import annotations

import numpy as np
import torch

from svbench.gen import msa_rounds
from svbench.engines import _events
from svbench.metrics import _work
from svbench.reference import gotoh as ref_gotoh
from svbench.reference.lcs import lcs_length

GO, GE = -10, -1


class Engine:
    def __init__(self, cell: dict, config: dict, seed: int, device, spans):
        from delly_tpu_torch.ops import gotoh_cuda, lcs_cuda

        self._lcs = lcs_cuda.lcs
        self._fwd = gotoh_cuda.gotoh_forward
        self._tb = gotoh_cuda.gotoh_traceback
        self.cell, self.config, self.seed = cell, config, seed
        self.device, self.spans = device, spans
        self._events = _events.Ring(device)
        self.pool = msa_rounds.make(cell, config, seed, device)
        pin = device.type == "cuda"

        def host(n, dtype, *shape):
            return torch.empty(n, *shape, dtype=dtype, pin_memory=pin)

        self.host = []
        self._cells, self._work = [], []
        for b in self.pool:
            x1 = b["x1"]
            out = {"x1": host(len(x1["al_h"]), torch.int32), "groups": []}
            cells = int((x1["al_h"].astype(np.int64)
                         * x1["bl_h"].astype(np.int64)).sum())
            work = {"x1": _work.bound_s(*_work.lcs(
                x1["word_steps"], x1["al_h"], x1["bl_h"])), "k2": 0.0}
            for grp in b["groups"]:
                G, K = len(grp["m_h"]), grp["K"]
                out["groups"].append((host(G, torch.int32),
                                      host(G, torch.uint8, 2 * K),
                                      host(G, torch.int32)))
                cells += int((grp["m_h"] * grp["n_h"]).sum())
                work["k2"] += _work.bound_s(*_work.gotoh(
                    grp["m_h"], grp["n_h"], grp["multi"]))
            self.host.append(out)
            self._cells.append(cells)
            self._work.append(work)

    def enqueue(self, i: int):
        b, h = self.pool[i], self.host[i]
        x1 = b["x1"]
        with self.spans("lcs"):
            o = self._lcs(x1["a"], x1["al"], x1["b"], x1["bl"], x1["lut"],
                          x1["nalpha"], host_lengths=(x1["al_h"], x1["bl_h"]))
        h["x1"].copy_(o, non_blocking=True)
        for grp, (hb, hc, hl) in zip(b["groups"], h["groups"]):
            with self.spans("gotoh"):
                best, bits = self._fwd(grp["prof"], grp["wc2"], grp["d2"],
                                       grp["ml"], grp["nl"], True, True, GO,
                                       GE)
            with self.spans("gotoh_tb"):
                codes, lens = self._tb(bits, grp["ml"], grp["nl"])
            hb.copy_(best, non_blocking=True)
            hc.copy_(codes, non_blocking=True)
            hl.copy_(lens, non_blocking=True)
        return i, self._events.record()

    def collect(self, handle):
        i, ev = handle
        if ev is not None:
            ev.synchronize()
        return self.host[i]

    def warmed(self, i: int, out) -> None:
        """K2-tb's work is its walks' steps: read from the warm-up."""
        steps = np.concatenate([hl.numpy() for _b, _c, hl in out["groups"]])
        self._work[i]["k2tb"] = _work.bound_s(*_work.gotoh_tb(steps))

    def keep(self, out):
        return {"x1": out["x1"].numpy().copy(),
                "groups": [(b.numpy().copy(), c.numpy().copy(),
                            n.numpy().copy()) for b, c, n in out["groups"]]}

    def cells(self, i: int) -> int:
        return self._cells[i]

    def work(self, i: int) -> dict:
        """{kernel: its bound in seconds} for pool batch i."""
        return self._work[i]

    def _sample(self, i: int) -> dict:
        """{K: [(group index, merge indices)]}: per K bucket, up to
        `check_merges` merges drawn from the seed across its groups in
        proportion, and each group's largest."""
        b = self.pool[i]
        rng = np.random.default_rng([int(self.seed) % (1 << 63), 11, i])
        by_k: dict = {}
        for gi, grp in enumerate(b["groups"]):
            by_k.setdefault(grp["K"], []).append(gi)
        out = {}
        for K, gis in by_k.items():
            total = sum(len(b["groups"][gi]["m_h"]) for gi in gis)
            want = int(self.cell.get("check_merges", 4096))
            picks = []
            for gi in gis:
                cells = b["groups"][gi]["m_h"] * b["groups"][gi]["n_h"]
                G = len(cells)
                n = min(G, max(1, want * G // max(total, 1)))
                idx = rng.choice(G, size=n, replace=False)
                picks.append((gi, np.unique(np.append(idx,
                                                      np.argmax(cells)))))
            out[K] = picks
        return out

    def references(self, i: int, band=None) -> dict:
        """{"x1": LCS lengths of every pair, "merges": {(group, merge):
        (best, codes, len)}} of pool batch i by the plain references."""
        b = self.pool[i]
        x1 = b["x1"]
        block = 1 << 16
        lens = [lcs_length(x1["a"][lo:lo + block], x1["al"][lo:lo + block],
                           x1["b"][lo:lo + block], x1["bl"][lo:lo + block])
                .cpu().numpy() for lo in range(0, len(x1["al_h"]), block)]
        merges = {}
        for K, picks in self._sample(i).items():
            # (group, merge) keys, group by group
            keys = [(gi, int(k)) for gi, idx in picks for k in idx]
            step = 4096 if K <= 128 else 1024
            for lo in range(0, len(keys), step):
                chunk = keys[lo:lo + step]
                parts = {}
                for key in ("a1", "r1", "m", "a2", "r2", "n"):
                    vals = []
                    for gi in dict.fromkeys(g for g, _k in chunk):
                        sel = torch.tensor([k for g, k in chunk if g == gi],
                                           device=self.device)
                        vals.append(b["groups"][gi][key][sel])
                    if key in ("a1", "a2"):
                        R = max(v.shape[1] for v in vals)
                        vals = [torch.nn.functional.pad(
                            v, (0, 0, 0, R - v.shape[1])) for v in vals]
                    parts[key] = torch.cat(vals)
                mm, nn = int(parts["m"].max()), int(parts["n"].max())
                best, codes, wl = (x.cpu().numpy() for x in ref_gotoh.merge(
                    parts["a1"][:, :, :mm], parts["r1"], parts["m"],
                    parts["a2"][:, :, :nn], parts["r2"], parts["n"],
                    band=band))
                for j, key in enumerate(chunk):
                    merges[key] = (int(best[j]), codes[j, :wl[j]],
                                   int(wl[j]))
        return {"x1": np.concatenate(lens), "merges": merges}

    def check(self, kept: dict, control: bool = False) -> tuple:
        """({name: (value, limit)}, outputs found wrong) of the kept
        outputs {pool index: [outputs]}, or, with `control`, of the
        banded reference put in the program's place."""
        bad_x1 = bad_best = bad_walk = failed = 0
        for i, outs in sorted(kept.items()):
            ref = self.references(i)
            if control:
                ctrl = self.references(i, self.config["control"]["band"])
                outs = [ctrl]
            for o in outs:
                wrong = 0
                if control:
                    got_x1 = o["x1"]
                    got = o["merges"]
                else:
                    got_x1 = o["x1"]
                    got = {}
                    for (gi, k) in ref["merges"]:
                        hb, hc, hl = o["groups"][gi]
                        n = int(hl[k])
                        got[(gi, k)] = (int(hb[k]), hc[k, :n], n)
                d = int((got_x1.astype(np.int64) != ref["x1"]).sum())
                bad_x1 += d
                wrong += d
                for key, (best, codes, n) in ref["merges"].items():
                    gb, gc, gn = got[key]
                    if gb != best:
                        bad_best += 1
                        wrong += 1
                    if gn != n or not np.array_equal(gc, codes):
                        bad_walk += 1
                        wrong += 1
                failed += wrong > 0
        return {"x1_lengths_wrong": (bad_x1, 0),
                "k2_scores_wrong": (bad_best, 0),
                "k2tb_walks_wrong": (bad_walk, 0)}, failed

    def release(self) -> None:
        self.host = None

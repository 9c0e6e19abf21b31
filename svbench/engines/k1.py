"""Engine `k1`: batches of (query, target) pairs through the port's K1
wrapper, `ops/myers_cuda.py myers`, at the device contract: uint8
pairs and int32 lengths resident on the card, the alphabet table, the
mode; int32 distances back in pinned host memory.

The pool comes from the maker that the cell names (svbench/gen/).
The alphabet table is the port's own (`alphabet_lut` over the bytes of
the padded batch, as `batched_edit_distance_myers` makes it). The
reference (svbench/reference/edit.py) checks every pair of every
output kept from the window.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from svbench.engines import _events
from svbench.metrics import _work
from svbench.reference.edit import edit_distance

MODES = {"NW": 0, "HW": 2}


class Engine:
    def __init__(self, cell: dict, config: dict, seed: int, device, spans):
        from delly_tpu_torch.ops import myers_cuda
        from delly_tpu_torch.ops.myers import alphabet_lut, alphabet_size

        self._myers = myers_cuda.myers
        self.cell, self.config, self.seed = cell, config, seed
        self.device, self.spans = device, spans
        self._events = _events.Ring(device)
        self.mode = MODES[cell["mode"]]
        maker = importlib.import_module(f"svbench.gen.{cell['maker']}")
        self.pool = maker.make(cell, config, seed, device)
        self.luts = []
        for b in self.pool:
            seen = torch.zeros(256, dtype=torch.bool, device=device)
            for x in (b["q"], b["t"]):
                seen |= torch.bincount(x.reshape(-1), minlength=256) > 0
            letters = np.flatnonzero(seen.cpu().numpy()).astype(np.uint8)
            lut = alphabet_lut(letters[None, :], letters[None, :0])
            self.luts.append((torch.from_numpy(lut).to(device),
                              alphabet_size(lut)))
        pin = device.type == "cuda"
        self.host = [torch.empty(len(b["qlens"]), dtype=torch.int32,
                                 pin_memory=pin) for b in self.pool]
        self._work = [{"k1": _work.bound_s(*_work.myers(
            b["qlens"], b["tlens"], self.mode))} for b in self.pool]
        self._cells = [int((b["qlens"] * b["tlens"]).sum())
                       for b in self.pool]

    def enqueue(self, i: int):
        b = self.pool[i]
        lut, nalpha = self.luts[i]
        with self.spans("myers"):
            d = self._myers(b["q"], b["ql"], b["t"], b["tl"], lut, self.mode,
                            nalpha)
        self.host[i].copy_(d, non_blocking=True)
        return i, self._events.record()

    def collect(self, handle):
        i, ev = handle
        if ev is not None:
            ev.synchronize()
        return self.host[i]

    def keep(self, out):
        return out.numpy().copy()

    def cells(self, i: int) -> int:
        return self._cells[i]

    def work(self, i: int) -> dict:
        """{kernel: its bound in seconds} for pool batch i."""
        return self._work[i]

    def references(self, pool_idx, band=None) -> dict:
        """{pool index: distances (int64 numpy) of its every pair} by the
        plain DP, or by its banded control; pool batches of one padded
        width run as one batch, in blocks of `check_block` pairs."""
        groups: dict = {}
        for i in pool_idx:
            b = self.pool[i]
            groups.setdefault((b["q"].shape[1], b["t"].shape[1]), []).append(i)
        block = int(self.cell.get("check_block", 1 << 16))
        out = {}
        for members in groups.values():
            cat = [torch.cat([self.pool[i][key] for i in members])
                   for key in ("q", "ql", "t", "tl")]
            dist = []
            for lo in range(0, len(cat[0]), block):
                q, ql, t, tl = (x[lo:lo + block] for x in cat)
                ml, nl = int(ql.max()), int(tl.max())
                dist.append(edit_distance(q[:, :ml], ql, t[:, :nl], tl,
                                          self.mode, band).cpu().numpy())
            dist = np.concatenate(dist)
            at = 0
            for i in members:
                n = len(self.pool[i]["qlens"])
                out[i] = dist[at:at + n]
                at += n
        return out

    def check(self, kept: dict, control: bool = False) -> tuple:
        """({name: (value, limit)}, outputs found wrong) of the kept
        outputs {pool index: [outputs]}, or, with `control`, of the
        banded control put in the program's place."""
        wrong = failed = 0
        refs = self.references(sorted(kept))
        if control:
            band = self.config["control"]["band"]
            ctrl = self.references(sorted(kept), band)
            kept = {i: [ctrl[i]] for i in kept}
        for i, outs in sorted(kept.items()):
            for o in outs:
                bad = int((o.astype(np.int64) != refs[i]).sum())
                wrong += bad
                failed += bad > 0
        return {"k1_distances_wrong": (wrong, 0)}, failed

    def release(self) -> None:
        self.host = None

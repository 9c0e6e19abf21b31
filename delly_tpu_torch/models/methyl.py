"""5mC methylation support (MM/ML BAM tags) for long-read genotyping.

Reference: src/methyl.h — per-read methylation call vectors from MM/ML
tags, breakpoint-window REF/ALT accumulation, insertion-sequence
methylation via infix alignment of the read's inserted bases onto the
consensus insertion, CpG clustering/depth filters, and the MR/MA/MNC/MDV
FORMAT field summaries.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from delly_tpu_torch.io.bam import (
    CDEL, CDIFF, CEQUAL, CINS, CMATCH, CREF_SKIP, CSOFT_CLIP,
    FREVERSE,
)
from delly_tpu_torch.ops.edist import (
    EDOP_INSERT, EDOP_MATCH, EDOP_MISMATCH, MODE_HW, align, infix_start,
)
from delly_tpu_torch.utils.tags import is_translocation, revcomp

_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


@dataclass
class MethylInfo:
    """Per-SV methylation summary, -1 = no call (methyl.h:36-55)."""
    altSvStartL: int = -1
    altSvStartR: int = -1
    altSvRightL: int = -1
    altSvRightR: int = -1
    refSvStartL: int = -1
    refSvStartR: int = -1
    refSvRightL: int = -1
    refSvRightR: int = -1
    mncStartL: int = -1
    mncStartR: int = -1
    mncRightL: int = -1
    mncRightR: int = -1
    mdpStartL: int = -1
    mdpStartR: int = -1
    mdpRightL: int = -1
    mdpRightR: int = -1

    def format_fields(self, svt: int, cfg) -> dict:
        """MR/MA/MNC/MDV VCF FORMAT values (modvcf.h:622-657)."""
        is_ins = svt == 4
        is_del = svt == 2
        min_depth = getattr(cfg, "min_cpg_depth", 5)

        def mout(pct, depth):
            if pct < 0 or depth < 0 or depth < min_depth:
                return "."
            return str(pct)

        def ncout(v):
            return "." if v < 0 else str(v)

        mnc = [ncout(self.mncStartL), ncout(self.mncStartR),
               ncout(self.mncRightL), ncout(self.mncRightR)]
        mdv = [ncout(self.mdpStartL), ncout(self.mdpStartR),
               ncout(self.mdpRightL), ncout(self.mdpRightR)]
        ma = [
            mout(self.altSvStartL, self.mdpStartL),
            "." if is_del else mout(self.altSvStartR, self.mdpStartR),
            "." if is_del else mout(self.altSvRightL, self.mdpRightL),
            mout(self.altSvRightR, self.mdpRightR),
        ]
        mr = [
            mout(self.refSvStartL, self.mdpStartL),
            "." if is_ins else mout(self.refSvStartR, self.mdpStartR),
            "." if is_ins else mout(self.refSvRightL, self.mdpRightL),
            mout(self.refSvRightR, self.mdpRightR),
        ]
        return {"MR": ",".join(mr), "MA": ",".join(ma),
                "MNC": ",".join(mnc), "MDV": ",".join(mdv)}


@dataclass
class MethylAccum:
    """Raw per-SV counts (methyl.h:58-81). Index order:
    0=StartL 1=StartR 2=RightL 3=RightR."""
    alt_m: list = field(default_factory=lambda: [0, 0, 0, 0])
    alt_t: list = field(default_factory=lambda: [0, 0, 0, 0])
    ref_m: list = field(default_factory=lambda: [0, 0, 0, 0])
    ref_t: list = field(default_factory=lambda: [0, 0, 0, 0])
    cpg: list = field(default_factory=lambda: [{}, {}, {}, {}])


def build_methyl_calls(rec, prob_th: int):
    """Per-read fwd-strand methylation call vector (methyl.h:121-215).

    Returns (has_methyl, calls) where calls[i] is 1 (methylated 5mC),
    0 (unmodified C), or -1 (not a C in the forward-strand sequence).
    """
    length = rec.l_qseq
    calls = np.full(length, -1, dtype=np.int8)
    # the reference reads ONLY the canonical uppercase MM tag
    # (methyl.h:126); legacy Mm/Ml-tagged inputs yield missing fields
    mm = rec.aux("MM")
    if not isinstance(mm, str):
        return False, calls
    read_rev = bool(rec.flag & FREVERSE)

    sequence = rec.seq
    fwdseq = revcomp(sequence) if read_rev else sequence

    basepos = {}
    for i, ch in enumerate(fwdseq):
        basepos.setdefault(ch.upper(), []).append(i)

    # Parse MM tag: base strand codes[.?] , delta positions
    modhits = []  # (pos_ordinal, code, rev_mod, base)
    m_c_has_skip = False
    for tok in mm.split(";"):
        if not tok:
            continue
        idx = 0
        if idx >= len(tok):
            continue
        base = tok[idx]
        idx += 1
        if idx >= len(tok):
            continue
        strand = tok[idx]
        idx += 1
        rev_mod = strand == "-"
        mod_codes = []
        has_skip = False
        while idx < len(tok) and tok[idx] != ",":
            ch = tok[idx]
            idx += 1
            if ch in "?.":
                has_skip = True
            elif ch.isalpha():
                mod_codes.append(ch)
        if has_skip and any(c in "mM" for c in mod_codes):
            m_c_has_skip = True
        if idx < len(tok) and tok[idx] == ",":
            current = -1
            for pt in tok[idx + 1:].split(","):
                if not pt:
                    continue
                # std::stoi prefix parse (methyl.h:174): numeric
                # prefix of a malformed token still counts
                kk = 0
                if pt[0] in "+-":
                    kk = 1
                while kk < len(pt) and pt[kk].isdigit():
                    kk += 1
                if kk == 0 or (kk == 1 and pt[0] in "+-"):
                    continue
                current += int(pt[:kk]) + 1
                for mc in mod_codes:
                    modhits.append([current, mc, 255, rev_mod, base])

    if not m_c_has_skip:
        for i, ch in enumerate(fwdseq):
            if ch.upper() == "C":
                calls[i] = 0

    # ML probabilities (byte array parallel to the MM hits); the
    # reference only accepts the B,C (uint8) subtype (methyl.h:192)
    ml = rec.aux("ML")  # canonical tag only (methyl.h:189)
    if isinstance(ml, np.ndarray) and ml.dtype == np.uint8:
        for i in range(min(len(ml), len(modhits))):
            modhits[i][2] = int(ml[i])

    for pos, code, prob, rev_mod, base in modhits:
        if code not in ("m", "M"):
            continue
        ub = base.upper()
        target_base = _COMPLEMENT.get(ub, ub) if rev_mod else ub
        occs = basepos.get(target_base)
        if not occs or pos < 0 or pos >= len(occs):
            continue
        calls[occs[pos]] = 1 if prob >= prob_th else 0
    return True, calls


def collect_methyl_from_windows(rec, calls: np.ndarray, wins: list):
    """Count methylated/total C calls in reference windows
    (methyl.h:218-259). Returns (meth_counts, tot_counts, cpg_pos)."""
    nw = len(wins)
    meth = [0] * nw
    tot = [0] * nw
    cpg = [dict() for _ in range(nw)]
    if not wins or calls.size == 0:
        return meth, tot, cpg
    read_rev = bool(rec.flag & FREVERSE)
    length = rec.l_qseq
    max_end = max(w[1] for w in wins)
    rp = rec.pos
    sp = 0
    for op, ol in zip(rec.cigar_ops, rec.cigar_lens):
        ol = int(ol)
        if op in (CMATCH, CEQUAL, CDIFF):
            for _ in range(ol):
                if rp >= max_end:
                    return meth, tot, cpg
                fwd_pos = (length - sp - 1) if read_rev else sp
                if 0 <= fwd_pos < length:
                    call = calls[fwd_pos]
                    if call >= 0:
                        for wi, (wb, we) in enumerate(wins):
                            if wb <= rp < we:
                                tot[wi] += 1
                                if call == 1:
                                    meth[wi] += 1
                                cpg[wi][rp] = cpg[wi].get(rp, 0) + 1
                rp += 1
                sp += 1
        elif op in (CDEL, CREF_SKIP):
            rp += ol
            if rp >= max_end:
                return meth, tot, cpg
        elif op in (CINS, CSOFT_CLIP):
            sp += ol
    return meth, tot, cpg


def collect_methyl_from_insertion(cfg, rec, read_seq: str,
                                  calls: np.ndarray, sv_start: int,
                                  consensus: str, cons_bp: int,
                                  ins_len: int, accum: MethylAccum):
    """Methylation of the inserted sequence itself via infix alignment of
    the read's inserted bases onto the consensus insertion
    (methyl.h:262-415). Accumulates into StartR (idx 1) and RightL (2)."""
    length = len(read_seq)
    if length == 0 or ins_len <= 0:
        return
    if cons_bp < 0 or cons_bp + ins_len > len(consensus):
        return
    read_rev = bool(rec.flag & FREVERSE)

    # Locate the insertion in the read (CIGAR I at svStart, or a clip)
    ins_read_start = -1
    ins_read_len = 0
    min_op_len = max(1, min(ins_len // 2, cfg.methyl_window // 2))
    maps_before_bp = rec.pos < sv_start
    rp = rec.pos
    sp = 0
    ops = rec.cigar_ops
    lens = rec.cigar_lens
    n_cigar = len(ops)
    for ci in range(n_cigar):
        op = ops[ci]
        ol = int(lens[ci])
        if op in (CMATCH, CEQUAL, CDIFF):
            rp += ol
            sp += ol
        elif op in (CDEL, CREF_SKIP):
            rp += ol
        elif op == CINS:
            if rp == sv_start and ol >= min_op_len:
                ins_read_start = sp
                ins_read_len = ol
                break
            sp += ol
        elif op == CSOFT_CLIP:
            if ol >= min_op_len:
                is_first = ci == 0
                is_last = ci == n_cigar - 1
                want_first = not maps_before_bp
                if (want_first and is_first) or (not want_first and is_last):
                    if ol > ins_read_len:
                        ins_read_start = sp
                        ins_read_len = ol
            sp += ol
    if ins_read_start < 0:
        return
    ins_read_len = min(ins_read_len, length - ins_read_start)
    if ins_read_len <= 0:
        return

    read_ins = read_seq[ins_read_start:ins_read_start + ins_read_len]
    cons_ins = consensus[cons_bp:cons_bp + ins_len]

    dist, end_loc, aln_ops = align(read_ins, cons_ins, MODE_HW)
    if dist < 0 or len(aln_ops) == 0:
        return
    t_start = infix_start(aln_ops, end_loc)

    # consensus-insertion position -> read-insertion position.
    # NOTE: the reference (methyl.h:335-344) advances the target index on
    # INSERT and the query index on DELETE, which is inverted relative to
    # edlib's own op convention (and to assemble.h's use of the same ops).
    # We mirror the reference's behavior for parity.
    cons_to_read = np.full(ins_len, -1, dtype=np.int64)
    qi = 0
    ti = t_start
    for op in aln_ops:
        if qi >= len(read_ins) or ti >= ins_len:
            break
        if op in (EDOP_MATCH, EDOP_MISMATCH):
            cons_to_read[ti] = qi
            qi += 1
            ti += 1
        elif op == EDOP_INSERT:
            cons_to_read[ti] = -1
            ti += 1
        else:
            qi += 1

    cpgtol = 8
    wlen = min(cfg.methyl_window, ins_len)
    for window in range(2):
        win_start = 0 if window == 0 else ins_len - wlen
        win_end = wlen if window == 0 else ins_len
        idx = 1 if window == 0 else 2  # StartR / RightL
        for k in range(win_start, win_end - 1):
            ck = cons_ins[k].upper()
            ck1 = cons_ins[k + 1].upper()
            if ck != "C" or ck1 != "G":
                continue
            call = -1
            if not read_rev:
                ri_center = int(cons_to_read[k])
                if ri_center < 0:
                    continue
                for delta in range(cpgtol + 1):
                    if call >= 0:
                        break
                    signs = (0,) if delta == 0 else (-1, 1)
                    for sign in signs:
                        ri = ri_center + delta * sign
                        if ri < 0 or ri + 1 >= len(read_ins):
                            continue
                        if read_ins[ri].upper() != "C":
                            continue
                        if read_ins[ri + 1].upper() != "G":
                            continue
                        pos = ins_read_start + ri
                        if pos < 0 or pos >= length:
                            continue
                        if calls[pos] < 0:
                            continue
                        call = int(calls[pos])
                        break
            else:
                if k + 1 >= ins_len:
                    continue
                ri_g_center = int(cons_to_read[k + 1])
                if ri_g_center < 0:
                    continue
                for delta in range(cpgtol + 1):
                    if call >= 0:
                        break
                    signs = (0,) if delta == 0 else (-1, 1)
                    for sign in signs:
                        ri_g = ri_g_center + delta * sign
                        if ri_g < 1 or ri_g >= len(read_ins):
                            continue
                        if read_ins[ri_g - 1].upper() != "C":
                            continue
                        if read_ins[ri_g].upper() != "G":
                            continue
                        pos = length - 1 - (ins_read_start + ri_g)
                        if pos < 0 or pos >= length:
                            continue
                        if calls[pos] < 0:
                            continue
                        call = int(calls[pos])
                        break
            if call < 0:
                continue
            accum.cpg[idx][k] = accum.cpg[idx].get(k, 0) + 1
            accum.alt_t[idx] += 1
            if call == 1:
                accum.alt_m[idx] += 1


def cluster_and_filter_cpg(cpg_map: dict, min_depth: int) -> int:
    """Merge adjacent (fwd/rev) CpG observations and count clusters that
    reach the depth threshold (methyl.h:418-441)."""
    if not cpg_map:
        return 0
    positions = sorted(cpg_map)
    count = 0
    cluster_start = positions[0]
    cluster_depth = cpg_map[positions[0]]
    for pos in positions[1:]:
        if pos <= cluster_start + 1:
            cluster_depth += cpg_map[pos]
        else:
            if cluster_depth >= min_depth:
                count += 1
            cluster_start = pos
            cluster_depth = cpg_map[pos]
    if cluster_depth >= min_depth:
        count += 1
    return count


def finalize_methyl_info(accum: MethylAccum, min_cpg_depth: int) -> MethylInfo:
    """Percentages, CpG cluster counts and mean depths (methyl.h:444-469)."""
    from delly_tpu_torch.utils.stats import iround

    def pct(m, t):
        # std::round (half away from zero, not banker's) of the
        # float32 expression 100.0f*(float)m/(float)t (methyl.h:447)
        if t <= 0:
            return -1
        return iround(float(np.float32(100.0) * np.float32(m)
                            / np.float32(t)))

    def mdp(ta, tr, cpg_n):
        if cpg_n <= 0:
            return -1
        return iround(float(np.float32(ta + tr) / np.float32(cpg_n)))

    mi = MethylInfo()
    (mi.altSvStartL, mi.altSvStartR, mi.altSvRightL, mi.altSvRightR) = [
        pct(accum.alt_m[i], accum.alt_t[i]) for i in range(4)]
    (mi.refSvStartL, mi.refSvStartR, mi.refSvRightL, mi.refSvRightR) = [
        pct(accum.ref_m[i], accum.ref_t[i]) for i in range(4)]
    mnc = [cluster_and_filter_cpg(accum.cpg[i], min_cpg_depth)
           for i in range(4)]
    (mi.mncStartL, mi.mncStartR, mi.mncRightL, mi.mncRightR) = mnc
    (mi.mdpStartL, mi.mdpStartR, mi.mdpRightL, mi.mdpRightR) = [
        mdp(accum.alt_t[i], accum.ref_t[i], mnc[i]) for i in range(4)]
    return mi


def accumulate_methyl(cfg, rec, calls: np.ndarray, sv, ref_index: int,
                      chrom_len: int, is_alt: bool, candidates: list,
                      accum: MethylAccum, read_seq: str):
    """Window selection + accumulation for one read/SV (methyl.h:472-568)."""
    if calls.size == 0:
        return
    sv_start = sv.svStart
    sv_end = sv.svEnd
    ins_len = sv.insLen
    is_trans = is_translocation(sv.svt)
    is_ins = sv.svt == 4
    is_del = sv.svt == 2

    on_start = any(c == sv_start and sv.chr == ref_index
                   for c in candidates)
    on_end = any(c == sv_end and sv.chr2 == ref_index for c in candidates)
    if not on_start and not on_end:
        return

    wins = []
    fields = []
    if on_start:
        beg = max(0, sv_start - cfg.methyl_window)
        if sv_start > beg:
            wins.append((beg, sv_start))
            fields.append(0)
        if not is_ins and not (is_alt and is_del):
            rbeg = sv_start
            rend = (min(sv_start + cfg.methyl_window, sv_end)
                    if not is_trans
                    else min(sv_start + cfg.methyl_window, chrom_len))
            if rend > rbeg:
                wins.append((rbeg, rend))
                fields.append(1)
    if on_end:
        if not is_ins and not (is_alt and is_del):
            lbeg = (max(sv_start, sv_end - cfg.methyl_window)
                    if not is_trans else max(0, sv_end - cfg.methyl_window))
            if sv_end > lbeg:
                wins.append((lbeg, sv_end))
                fields.append(2)
        rbeg = sv_end
        rend = min(sv_end + cfg.methyl_window, chrom_len)
        if rend > rbeg:
            wins.append((rbeg, rend))
            fields.append(3)

    if wins:
        meth, tot, cpg = collect_methyl_from_windows(rec, calls, wins)
        for i, fld in enumerate(fields):
            if is_alt:
                accum.alt_m[fld] += meth[i]
                accum.alt_t[fld] += tot[i]
            else:
                accum.ref_m[fld] += meth[i]
                accum.ref_t[fld] += tot[i]
            for pos, depth in cpg[i].items():
                accum.cpg[fld][pos] = accum.cpg[fld].get(pos, 0) + depth

    if (is_ins and is_alt and ins_len > 0 and (on_start or on_end)
            and read_seq and sv.consensus):
        collect_methyl_from_insertion(cfg, rec, read_seq, calls, sv_start,
                                      sv.consensus, sv.consBp, ins_len,
                                      accum)

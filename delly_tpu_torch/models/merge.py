"""Multi-sample SV site merging (delly merge).

Reference: src/merge.h. Per-SV-type merge across single-sample VCF/BCFs:
collect nodes with AC/SUPP/VAF gating from genotypes, windowed
single-linkage union-find with subtype-aware matching (MEI / TR / normal
windows, reciprocal overlap, sequence identity including rotations),
allele grouping within loci (DEL allele split by sequence identity with
rare-allele absorption), representative selection with quality gates,
site-list emission with AC/AN/AF/SUPP, consensus synthesis from the
reference for external callers, interval-based CNV merging, TR/VNTR
locus regrouping, k-way sorted merge of the per-type results, and
chunked merging for >chunksize input files.
"""

from __future__ import annotations

import numpy as _np

import heapq
import math
import os
import sys
import tempfile
from dataclasses import dataclass, field

from delly_tpu_torch.io.vcf import VcfReader, VcfWriter, fmt_float, fmt_float32
from delly_tpu_torch.ops.edist import MODE_NW, edit_distance
from delly_tpu_torch.utils.tags import (
    SVT_TRANS, add_id, add_orientation, decode_orientation, entropy,
    is_translocation,
)
from delly_tpu_torch.version import SVMETHOD
from delly_tpu_torch.utils.log import stage


@dataclass
class MergeConfig:
    """merge.h:44-78, defaults merge.h:1879-1919."""
    files: list = field(default_factory=list)
    outfile: str = "-"
    genome: str = ""
    qualthres: int = 200
    recurrent_samples: int = 10
    chunksize: int = 500
    vaf: float = 0.15
    coverage: int = 5
    minsize: int = 0
    maxsize: int = 1000000
    cnv_mode: bool = False
    filter_for_precise: bool = False
    filter_for_pass: bool = False
    bpoffset: int = 1000
    recoverlap: float = 0.8
    rep_min_af: float = 0.005
    mei_offset: int = 50
    mei_size_ratio: float = 0.85
    mei_seq_id: float = 0.8
    tr_offset: int = 200
    tr_frac: float = 0.25
    tr_seq_id: float = 0.7
    norm_frac: float = 0.5
    junc_seq_id: float = 0.7
    seq_cutoff: int = 10000
    cnv_large_size: int = 200000
    cnv_min_uniq: float = 0.75
    cnv_gain_uniq: float = 0.9
    # internal state
    svcounter: int = 1
    allele_counter: int = 1
    total_samples: int = 0

    def __post_init__(self):
        # the reference stores these thresholds as float32
        # (merge.h:44-78) and compares them promoted to double —
        # exact-boundary values like vaf == 0.15 must round-trip the
        # same way here (0.15f > 0.15 as double)
        import numpy as np
        for f in ("vaf", "recoverlap", "rep_min_af", "mei_size_ratio",
                  "mei_seq_id", "tr_frac", "tr_seq_id", "norm_frac",
                  "junc_seq_id", "cnv_min_uniq", "cnv_gain_uniq"):
            setattr(self, f, float(np.float32(getattr(self, f))))


@dataclass
class MergeSV:
    """merge.h:94-121."""
    tid: int = 0
    mtid: int = 0
    svStart: int = 0
    svEnd: int = 0
    pos2: int = 0
    size: int = 0
    svt: int = -1
    homlen: int = 0
    trperiod: int = 0
    score: int = 0
    fileIdx: int = 0
    supp: int = 1
    ac: int = 1
    sr: int = 0
    srmapq: int = 0
    altSupport: int = 0
    subtype: int = 0
    insStrand: int = -1
    hap: int = -1
    precise: bool = False
    fromSiteList: bool = False
    srq: float = 0.0
    ce: float = 0.0
    id: str = ""
    seq: str = ""


@dataclass
class MergeAgg:
    ac: int = 0
    an: int = 0
    supp: int = 0
    ciposLo: int = 0
    ciposHi: int = 0
    ciendLo: int = 0
    ciendHi: int = 0
    alleleId: int = 0
    nAllele: int = 1


def rec_overlap(s1, e1, s2, e2) -> float:
    """Reciprocal overlap (merge.h:81-91)."""
    if e1 < s2 or s1 > e2:
        return 0.0
    len_a = e1 - s1
    len_b = e2 - s2
    if len_a <= 0 or len_b <= 0:
        return 0.0
    overlap = min(e1, e2) - max(s1, s2)
    if overlap <= 0:
        return 0.0
    return overlap / max(len_a, len_b)


def subtype_code(s: str) -> int:
    """merge.h:143-154."""
    if "ME:ALU" in s:
        return 1
    if "ME:LINE1" in s:
        return 2
    if "ME:SVA" in s:
        return 3
    if "NUMT" in s:
        return 4
    if "LTR" in s:
        return 5
    if "HERVK" in s:
        return 6
    if "TR" in s:
        return 7
    return 0


def merge_decode_svt(svt: str, ct: str | None) -> int:
    """merge.h:156-167."""
    if ct is not None:
        return decode_orientation(ct, svt)
    if svt == "DEL":
        return 2
    if svt == "INS":
        return 4
    if svt.startswith("DUP"):
        return 3
    if svt.startswith("INV"):
        return 0
    if svt == "CNV":
        return 9
    if svt in ("BND", "TRA"):
        return SVT_TRANS
    return -1


def parse_bnd_mate(alt: str):
    """merge.h:169-186. Returns (chr2, pos2) or None."""
    lb = -1
    for i, ch in enumerate(alt):
        if ch in "[]":
            lb = i
            break
    if lb < 0:
        return None
    br = alt[lb]
    rb = alt.find(br, lb + 1)
    if rb < 0:
        return None
    loc = alt[lb + 1:rb]
    colon = loc.rfind(":")
    if colon < 0:
        return None
    try:
        return loc[:colon], int(loc[colon + 1:])
    except ValueError:
        return None


def min_rotation(s: str) -> str:
    """Booth's least-rotation (merge.h:188-208)."""
    if len(s) < 2:
        return s
    dbl = s + s
    n = len(dbl)
    f = [-1] * n
    k = 0
    for j in range(1, n):
        sj = dbl[j]
        i = f[j - k - 1]
        while i != -1 and sj != dbl[k + i + 1]:
            if sj < dbl[k + i + 1]:
                k = j - i - 1
            i = f[i]
        if sj != dbl[k + i + 1]:
            if sj < dbl[k]:
                k = j
            f[j - k] = -1
        else:
            f[j - k] = i + 1
    return dbl[k:k + len(s)]


def seq_identity(a: str, b: str, min_id: float) -> float:
    """NW identity with an edit-distance cap (merge.h:210-223)."""
    if not a or not b:
        return -1.0
    maxlen = max(len(a), len(b))
    k = -1
    if 0.0 < min_id < 1.0:
        k = int((1.0 - min_id) * maxlen)
    d, _ = edit_distance(a, b, MODE_NW, k=k)
    if d >= 0:
        return 1.0 - d / maxlen
    return 0.0 if k >= 0 else -1.0


def best_seq_identity(a: str, b: str, pos_off: int, min_id: float,
                      seq_cutoff: int) -> float:
    """Identity with positional and canonical rotations
    (merge.h:226-243)."""
    if not a or not b:
        return -1.0
    best = seq_identity(a, b, min_id)
    if min_id > 0.0 and best >= min_id:
        return best
    if len(a) < seq_cutoff and len(b) < seq_cutoff:
        f = pos_off % len(b)
        if f > 0:
            rot = b[len(b) - f:] + b[:len(b) - f]
            best = max(best, seq_identity(a, rot, min_id))
            if min_id > 0.0 and best >= min_id:
                return best
        best = max(best, seq_identity(min_rotation(a), min_rotation(b),
                                      min_id))
    return best


def sv_match(cfg: MergeConfig, a: MergeSV, b: MergeSV) -> bool:
    """Subtype-aware matching (merge.h:246-309)."""
    if is_translocation(a.svt):
        if a.mtid != b.mtid:
            return False
        win = max(cfg.bpoffset, a.homlen, b.homlen)
        if abs(a.svStart - b.svStart) > win:
            return False
        if abs(a.pos2 - b.pos2) > win:
            return False
        if (a.seq and b.seq
                and max(len(a.seq), len(b.seq)) < cfg.seq_cutoff):
            sid = seq_identity(a.seq, b.seq, cfg.junc_seq_id)
            if 0 <= sid < cfg.junc_seq_id:
                return False
        return True

    pos_off = abs(a.svStart - b.svStart)
    max_hom = max(a.homlen, b.homlen)
    min_s = min(a.size, b.size)
    max_s = max(a.size, b.size)
    size_ratio = min_s / max_s if max_s > 0 else 1.0
    st = a.subtype if a.subtype else b.subtype
    if a.subtype and b.subtype and a.subtype != b.subtype:
        st = min(a.subtype, b.subtype)

    if 1 <= st <= 6:
        if a.insStrand >= 0 and b.insStrand >= 0 \
                and a.insStrand != b.insStrand:
            return False
        win = max(cfg.mei_offset, max_hom + 10)
        if pos_off > win:
            return False
        if size_ratio < cfg.mei_size_ratio:
            return False
        if a.seq and b.seq and max_s < cfg.seq_cutoff:
            sid = best_seq_identity(a.seq, b.seq, pos_off, cfg.mei_seq_id,
                                    cfg.seq_cutoff)
            if 0 <= sid < cfg.mei_seq_id:
                return False
        return True
    if st == 7:
        win = max(cfg.tr_offset, int(cfg.tr_frac * max_s))
        if a.trperiod > 0:
            win = max(win, 2 * a.trperiod)
        if b.trperiod > 0:
            win = max(win, 2 * b.trperiod)
        if pos_off > win:
            return False
        if a.seq and b.seq and max_s < cfg.seq_cutoff:
            sid = best_seq_identity(a.seq, b.seq, pos_off, cfg.tr_seq_id,
                                    cfg.seq_cutoff)
            if 0 <= sid < cfg.tr_seq_id:
                return False
        return True
    win = min(cfg.bpoffset, int(cfg.norm_frac * max_s))
    if win < 50:
        win = 50
    if win < max_hom:
        win = max_hom
    if pos_off > win:
        return False
    if rec_overlap(a.svStart, a.svEnd, b.svStart, b.svEnd) < cfg.recoverlap:
        return False
    if a.svt == 4 and size_ratio < 0.7:
        return False
    if (a.svt in (0, 3) and a.seq and b.seq
            and max(len(a.seq), len(b.seq)) < cfg.seq_cutoff):
        sid = seq_identity(a.seq, b.seq, cfg.junc_seq_id)
        if 0 <= sid < cfg.junc_seq_id:
            return False
    return True


class UnionFind:
    """merge.h:313-338."""

    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def unite(self, a: int, b: int) -> None:
        a = self.find(a)
        b = self.find(b)
        if a == b:
            return
        if self.rank[a] < self.rank[b]:
            a, b = b, a
        self.parent[b] = a
        if self.rank[a] == self.rank[b]:
            self.rank[a] += 1


def _rec_qual(rec) -> float:
    try:
        return float(rec["qual"])
    except (TypeError, ValueError):
        return float("nan")


def _info_int(info, key, default=0):
    try:
        return int(str(info[key]).split(",")[0])
    except (KeyError, ValueError):
        return default


def _info_float(info, key, default=0.0):
    try:
        return float(str(info[key]).split(",")[0])
    except (KeyError, ValueError):
        return default


def _fmt_int(sm: dict, key: str):
    """FORMAT field as int, or None on '.'/absent (module-level: a
    per-sample closure here costs one function object per genotype)."""
    v = sm.get(key, ".")
    try:
        return int(v)
    except ValueError:
        return None


def collect_svtype(cfg: MergeConfig, svtin: int, contig_map: dict,
                   readers: list) -> list:
    """Pass 1: read all records for one SV type (merge.h:341-629)."""
    stage("Reading input VCF/BCF files")
    nodes = []
    for file_c, rdr in enumerate(readers):
        site_list = len(rdr.samples) == 0
        # svt decode happens once per record, not once per svt pass:
        # bucket the reader's records by decoded svt on first use
        # (readers are cached across the nine per-type passes).
        buckets = getattr(rdr, "_svt_buckets", None)
        if buckets is None:
            buckets = {}
            for rec in rdr.records:
                info = rec["info"]
                svt_str = info.get("SVTYPE")
                if svt_str is None:
                    continue
                ct = info.get("CT")
                dsvt = merge_decode_svt(
                    str(svt_str), str(ct) if ct is not None else None)
                buckets.setdefault(dsvt, []).append(rec)
            rdr._svt_buckets = buckets
        for rec in buckets.get(svtin, ()):
            info = rec["info"]
            if cfg.filter_for_pass and rec["filter"] != "PASS":
                continue
            recsvt = svtin
            precise = "PRECISE" in info
            if cfg.filter_for_precise and not precise:
                continue
            q = _rec_qual(rec)
            if q == q and q < cfg.qualthres:  # NaN passes (htslib semantics)
                continue
            if rec["chrom"] not in contig_map:
                continue
            tid = contig_map[rec["chrom"]]
            sv_start = rec["pos"] - 1
            sv_end = sv_start + 2
            real_size = 0
            if "END" in info:
                sv_end = _info_int(info, "END")
            if recsvt == 4:
                inslen = _info_int(info, "INSLEN")
                if inslen == 0:
                    inslen = abs(_info_int(info, "SVLEN"))
                if inslen < cfg.minsize or inslen > cfg.maxsize:
                    continue
                real_size = inslen
                sv_end = sv_start + inslen
            elif not is_translocation(recsvt):
                real_size = sv_end - sv_start
                if real_size <= 0:
                    real_size = abs(_info_int(info, "SVLEN"))
                    sv_end = sv_start + real_size
                if real_size < cfg.minsize or real_size > cfg.maxsize:
                    continue

            mtid = tid
            pos2val = 0
            if "CHR2" in info:
                if str(info["CHR2"]) in contig_map:
                    mtid = contig_map[str(info["CHR2"])]
                pos2val = _info_int(info, "POS2")
            elif is_translocation(recsvt):
                mate = parse_bnd_mate(rec["alt"])
                if mate:
                    if mate[0] in contig_map:
                        mtid = contig_map[mate[0]]
                    pos2val = mate[1]

            supp_val = 1
            ac_val = 1
            alt_support = 0
            if site_list:
                supp_val = _info_int(info, "SUPP", 1)
                ac_val = _info_int(info, "AC", 1)
            else:
                carriers = 0
                alleles = 0
                max_var = 0
                # GT presence is a RECORD-level property (the FORMAT
                # column declares GT, merge.h ngt > 0); with it present,
                # a sample whose alleles are missing ('.', './.') is
                # SKIPPED — not routed to the no-genotype VAF branch
                # (merge.h:484-487). Even an all-missing-GT record must
                # therefore drop (carriers == 0), not re-qualify by VAF.
                smps = rec.get("samples", [])
                has_gt = bool(smps) and "GT" in smps[0]
                for sm in smps:
                    gt = sm.get("GT", ".")
                    a0 = a1 = 0
                    if has_gt:
                        parts = gt.replace("|", "/").split("/")
                        if (gt in (".", "") or "." in parts
                                or len(parts) != 2):
                            continue
                        a0, a1 = int(parts[0]), int(parts[1])
                    altcn = (1 if a0 > 0 else 0) + (1 if a1 > 0 else 0)
                    support_sum = 0
                    var_reads = 0
                    vaf_val = 0.0

                    rr, rv = _fmt_int(sm, "RR"), _fmt_int(sm, "RV")
                    dr, dv = _fmt_int(sm, "DR"), _fmt_int(sm, "DV")
                    if precise and rr is not None and rv is not None:
                        support_sum = rr + rv
                        var_reads = rv
                    elif dr is not None and dv is not None:
                        support_sum = dr + dv
                        var_reads = dv
                    if support_sum > 0:
                        vaf_val = var_reads / support_sum
                    if has_gt:
                        if altcn == 0:
                            continue
                    else:
                        if vaf_val < cfg.vaf or support_sum < cfg.coverage:
                            continue
                        altcn = 2 if vaf_val > 0.75 else 1
                    if cfg.vaf > 0 or cfg.coverage > 0:
                        if vaf_val < cfg.vaf or support_sum < cfg.coverage:
                            continue
                    carriers += 1
                    alleles += altcn
                    if var_reads > max_var:
                        max_var = var_reads
                if carriers == 0:
                    continue
                supp_val = carriers
                ac_val = alleles
                alt_support = max_var

            subtype = subtype_code(str(info.get("SUBTYPE", "")))
            ins_strand = -1
            ins_s = str(info.get("INSSTRAND", ""))
            if ins_s:
                ins_strand = 1 if ins_s[0] == "-" else 0
            # STDEV_POS substitutes only when HOMLEN is ABSENT — a
            # declared HOMLEN=0 stays 0 (merge.h:532-534 else-if)
            if "HOMLEN" in info:
                homlen = _info_int(info, "HOMLEN")
            elif "STDEV_POS" in info:
                homlen = int(_info_float(info, "STDEV_POS") + 0.5)
            else:
                homlen = 0
            tr_period = _info_int(info, "TRPERIOD")
            sr_val = _info_int(info, "SR")
            srmapq = _info_int(info, "SRMAPQ")
            srq = _info_float(info, "SRQ")
            ce = _info_float(info, "CE")

            seq = ""
            alt_allele = rec["alt"]
            ref_allele = rec["ref"]
            if recsvt == 4:
                if alt_allele and alt_allele[0] != "<":
                    if len(alt_allele) > 1 and real_size <= cfg.seq_cutoff:
                        seq = alt_allele[1:].upper()
                elif precise:
                    cons_bp = _info_int(info, "CONSBP", -1)
                    cons = str(info.get("CONSENSUS", "")).upper()
                    if (cons and cons_bp >= 0 and real_size > 0
                            and cons_bp + real_size <= len(cons)):
                        seq = cons[cons_bp:cons_bp + real_size]
            elif recsvt == 2 and real_size <= cfg.seq_cutoff:
                if len(ref_allele) > 1:
                    seq = ref_allele[1:].upper()
            elif recsvt in (0, 3) or is_translocation(recsvt):
                cons = str(info.get("CONSENSUS", "")).upper()
                if cons and len(cons) <= cfg.seq_cutoff:
                    seq = cons

            nodes.append(MergeSV(
                tid=tid, mtid=mtid, svStart=sv_start, svEnd=sv_end,
                pos2=pos2val, size=real_size, svt=recsvt, homlen=homlen,
                trperiod=tr_period, score=int(q) if q == q else 0,
                fileIdx=file_c, supp=supp_val, ac=ac_val, sr=sr_val,
                srmapq=srmapq, altSupport=alt_support, subtype=subtype,
                insStrand=ins_strand, precise=precise,
                fromSiteList=site_list, srq=srq, ce=ce, id=rec["id"],
                seq=seq))
    return nodes


def retain_allele(cfg: MergeConfig, rep: MergeSV, supp: int) -> bool:
    """merge.h:632-645."""
    min_singleton_sr = 3
    if supp >= cfg.recurrent_samples:
        return True
    if rep.fromSiteList:
        return True
    if is_translocation(rep.svt):
        return supp >= 2
    if not rep.precise:
        return supp >= 2
    if rep.srq > 0 or rep.sr > 0:
        return (rep.sr >= min_singleton_sr and rep.srmapq >= 20
                and rep.srq >= 0.8 and rep.ce >= 1.0)
    return rep.altSupport >= min_singleton_sr


def allele_sim(cfg: MergeConfig, a: MergeSV, b: MergeSV) -> float:
    """merge.h:648-657."""
    if a.seq and b.seq and max(len(a.seq), len(b.seq)) < cfg.seq_cutoff:
        sid = seq_identity(a.seq, b.seq, 0.0)
        if sid >= 0.0:
            return sid
    min_s = min(a.size, b.size)
    max_s = max(a.size, b.size)
    return min_s / max_s if max_s > 0 else 1.0


def _cluster_unionfind(cfg: MergeConfig, nodes: list) -> "UnionFind":
    """Windowed single-linkage clustering (merge.h:660-688), with the
    arithmetic arms of sv_match evaluated as numpy batches per node;
    pairs whose outcome depends on sequence identity (and all
    translocations) fall back to the scalar sv_match. Produces exactly
    the components of the pairwise loop."""
    import numpy as np

    n = len(nodes)
    uf = UnionFind(n)
    if n < 2:
        return uf
    tid = np.asarray([nd.tid for nd in nodes], dtype=np.int64)
    start = np.asarray([nd.svStart for nd in nodes], dtype=np.int64)
    end = np.asarray([nd.svEnd for nd in nodes], dtype=np.int64)
    size = np.asarray([nd.size for nd in nodes], dtype=np.int64)
    hom = np.asarray([nd.homlen for nd in nodes], dtype=np.int64)
    sub = np.asarray([nd.subtype for nd in nodes], dtype=np.int64)
    trp = np.asarray([nd.trperiod for nd in nodes], dtype=np.int64)
    istr = np.asarray([nd.insStrand for nd in nodes], dtype=np.int64)
    svt = np.asarray([nd.svt for nd in nodes], dtype=np.int64)
    slen = np.asarray([len(nd.seq) if nd.seq else 0 for nd in nodes],
                      dtype=np.int64)
    trans = np.asarray([is_translocation(nd.svt) for nd in nodes],
                       dtype=bool)
    scan_win = max(cfg.bpoffset, 2 * cfg.tr_offset)
    # per-tid segment starts for the window search
    seg_start = np.zeros(n, dtype=np.int64)
    for k in range(1, n):
        seg_start[k] = seg_start[k - 1] if tid[k] == tid[k - 1] else k
    # Candidate pairs (i, j in [j0_i, i)): start[] is sorted only
    # within each tid segment, so the window search is bounded to the
    # segment — pairs then satisfy the reference's scan-window break
    # (pos_off <= scan_win, merge.h:668-671) exactly, and arm windows
    # larger than scan_win (TR 2*trperiod, MEI maxHom+10) cannot
    # resurrect pairs the reference never tests. The union-find
    # partition is the transitive closure of the match relation, which
    # is order-independent, so all pairs are evaluated as one numpy
    # pass and united in bulk (vs the reference's per-i inner loop).
    idx = np.arange(n, dtype=np.int64)
    j0s = np.empty(n, dtype=np.int64)
    for s0 in np.unique(seg_start):
        s0 = int(s0)
        e0 = s0 + int(np.searchsorted(seg_start[s0:], s0, side="right"))
        j0s[s0:e0] = s0 + np.searchsorted(
            start[s0:e0], start[s0:e0] - scan_win, side="left")
    counts = np.maximum(idx - j0s, 0)
    if counts.sum() == 0:
        return uf
    # Evaluate in bounded pair blocks: peak memory stays
    # O(PAIR_BLOCK), not O(total window pairs) (large recurrent
    # cohorts have ~samples^2 pairs per locus).
    PAIR_BLOCK = 2_000_000
    ccum = np.concatenate(([0], np.cumsum(counts)))
    i_lo = 0
    while i_lo < n:
        i_hi = int(np.searchsorted(ccum, ccum[i_lo] + PAIR_BLOCK,
                                   side="left"))
        i_hi = max(i_hi, i_lo + 1)
        blk = slice(i_lo, i_hi)
        cblk = counts[blk]
        pi = np.repeat(idx[blk], cblk)
        within = np.arange(len(pi), dtype=np.int64) \
            - np.repeat(np.cumsum(cblk) - cblk, cblk)
        pj = np.repeat(j0s[blk], cblk) + within
        _match_pair_block(cfg, nodes, uf, n, pi, pj, start, end, size,
                          hom, sub, trp, istr, svt, slen, trans)
        i_lo = i_hi
    return uf


def _match_pair_block(cfg, nodes, uf, n, pi, pj, start, end, size, hom,
                      sub, trp, istr, svt, slen, trans):
    import numpy as np

    if len(pi) == 0:
        return
    # translocations go through the scalar matcher pair by pair
    tmask = trans[pi]
    for a, b in zip(pi[tmask].tolist(), pj[tmask].tolist()):
        if uf.find(a) != uf.find(b) and sv_match(cfg, nodes[a],
                                                 nodes[b]):
            uf.unite(a, b)
    keep = ~tmask
    pi, pj = pi[keep], pj[keep]
    if len(pi) == 0:
        return

    pos_off = start[pi] - start[pj]
    max_hom = np.maximum(hom[pi], hom[pj])
    min_s = np.minimum(size[pi], size[pj])
    max_s = np.maximum(size[pi], size[pj])
    size_ratio = np.where(max_s > 0, min_s / np.maximum(max_s, 1), 1.0)
    st = np.where(sub[pi] > 0, sub[pi], sub[pj])
    st = np.where((sub[pi] > 0) & (sub[pj] > 0),
                  np.minimum(sub[pi], sub[pj]), st)
    seq_pair = (slen[pi] > 0) & (slen[pj] > 0)
    max_len = np.maximum(slen[pi], slen[pj])

    mei = (st >= 1) & (st <= 6)
    tr = st == 7
    norm = ~mei & ~tr

    match = np.zeros(len(pi), dtype=bool)
    scalar = np.zeros(len(pi), dtype=bool)

    # MEI arm (merge.h:258-272)
    w_mei = np.maximum(cfg.mei_offset, max_hom + 10)
    ok = (mei & ~((istr[pi] >= 0) & (istr[pj] >= 0)
                  & (istr[pi] != istr[pj]))
          & (pos_off <= w_mei) & (size_ratio >= cfg.mei_size_ratio))
    need = ok & seq_pair & (max_s < cfg.seq_cutoff)
    match |= ok & ~need
    scalar |= need

    # TR arm (merge.h:274-284)
    w_tr = np.maximum(cfg.tr_offset,
                      (cfg.tr_frac * max_s).astype(np.int64))
    w_tr = np.maximum(w_tr, np.where(trp[pi] > 0, 2 * trp[pi], 0))
    w_tr = np.maximum(w_tr, np.where(trp[pj] > 0, 2 * trp[pj], 0))
    ok = tr & (pos_off <= w_tr)
    need = ok & seq_pair & (max_s < cfg.seq_cutoff)
    match |= ok & ~need
    scalar |= need

    # normal arm (merge.h:286-308)
    w_n = np.minimum(cfg.bpoffset,
                     (cfg.norm_frac * max_s).astype(np.int64))
    w_n = np.maximum(np.maximum(w_n, 50), max_hom)
    lo = np.maximum(start[pi], start[pj])
    hi = np.minimum(end[pi], end[pj])
    span = np.maximum(np.maximum(end[pi] - start[pi],
                                 end[pj] - start[pj]), 1)
    rec = np.where(hi > lo, (hi - lo) / span, 0.0)
    ok = norm & (pos_off <= w_n) & (rec >= cfg.recoverlap)
    ok &= ~((svt[pi] == 4) & (size_ratio < 0.7))
    seq_arm = (svt[pi] == 0) | (svt[pi] == 3)
    need = ok & seq_arm & seq_pair & (max_len < cfg.seq_cutoff)
    match |= ok & ~need
    scalar |= need

    _bulk_unite(uf, n, pi[match], pj[match])
    for a, b in zip(pi[scalar].tolist(), pj[scalar].tolist()):
        if uf.find(a) != uf.find(b) and sv_match(cfg, nodes[a],
                                                 nodes[b]):
            uf.unite(a, b)


def _bulk_unite(uf: "UnionFind", n: int, mi, mj) -> None:
    """Union all (mi, mj) edges: one sparse connected-components pass
    (O(n) unites into `uf`) instead of an O(edges) Python loop. The
    closure is order-independent, so the result partition is identical
    to pairwise unites."""
    import numpy as np

    if len(mi) == 0:
        return
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components
    except Exception:
        for a, b in zip(mi.tolist(), mj.tolist()):
            if uf.find(a) != uf.find(b):
                uf.unite(a, b)
        return
    g = coo_matrix((np.ones(len(mi), dtype=np.int8), (mi, mj)),
                   shape=(n, n))
    _nc, lab = connected_components(g, directed=False)
    order = np.argsort(lab, kind="stable")
    ls = lab[order]
    seg = np.flatnonzero(np.r_[True, ls[1:] != ls[:-1]])
    bounds = np.append(seg, len(ls))
    for k in range(len(seg)):
        members = order[bounds[k]:bounds[k + 1]]
        if len(members) < 2:
            continue
        r = int(members[0])
        for m in members[1:].tolist():
            if uf.find(r) != uf.find(m):
                uf.unite(r, m)


def cluster_and_select(cfg: MergeConfig, nodes: list,
                       out_groups: list | None = None) -> dict:
    """Pass 1b (merge.h:660-846). Returns {(fileIdx, id): MergeAgg}.
    When out_groups is given, (rep, members, agg) tuples are appended for
    each kept allele group (used by asm mode, merge.h:837-843)."""
    stage("Clustering and merging SVs")
    selected = {}
    if not nodes:
        return selected
    nodes.sort(key=lambda n: (n.tid, n.svStart))
    uf = _cluster_unionfind(cfg, nodes)

    comps = {}
    for i in range(len(nodes)):
        comps.setdefault(uf.find(i), []).append(i)

    for members in comps.values():
        members.sort(key=lambda a: nodes[a].size)
        groups = []
        if members and nodes[members[0]].svt == 2 and len(members) <= 20000:
            # keep distinct DEL alleles (merge.h:690-752)
            allele_id = 0.90
            order = sorted(members, key=lambda x: -nodes[x].score)
            lead = []
            for mi in order:
                g = -1
                for li, lv in enumerate(lead):
                    if allele_sim(cfg, nodes[mi], nodes[lv]) >= allele_id:
                        g = li
                        break
                if g < 0:
                    lead.append(mi)
                    groups.append([])
                    g = len(groups) - 1
                groups[g].append(mi)
            carrier_floor = max(1, math.ceil(cfg.rep_min_af
                                             * cfg.total_samples))
            if carrier_floor > 1 and len(groups) > 1:
                gcarr = [len({nodes[k].fileIdx for k in grp})
                         for grp in groups]
                kept_g = [g for g in range(len(groups))
                          if gcarr[g] >= carrier_floor]
                dest = [-1] * len(groups)
                for g in range(len(groups)):
                    if gcarr[g] >= carrier_floor:
                        continue
                    best = -1
                    best_sim = cfg.recoverlap
                    for s in kept_g:
                        sim = allele_sim(cfg, nodes[lead[g]],
                                         nodes[lead[s]])
                        if sim >= best_sim:
                            best_sim = sim
                            best = s
                    dest[g] = best
                merged = []
                out_idx = {}
                for g in range(len(groups)):
                    target = dest[g] if dest[g] >= 0 else g
                    if target not in out_idx:
                        out_idx[target] = len(merged)
                        merged.append([])
                    merged[out_idx[target]].extend(groups[g])
                groups = merged
        else:
            cur = []
            for k in members:
                if cur:
                    prev_size = nodes[cur[-1]].size
                    cur_size = nodes[k].size
                    gap = max(50, int(0.25 * max(cur_size, 1)))
                    if cur_size - prev_size > gap:
                        groups.append(cur)
                        cur = []
                cur.append(k)
            if cur:
                groups.append(cur)

        kept_groups = []
        rep_idx = []
        for grp in groups:
            rep = grp[0]
            for k in grp[1:]:
                if (nodes[k].score > nodes[rep].score
                        or (nodes[k].score == nodes[rep].score
                            and nodes[k].srq > nodes[rep].srq)):
                    rep = k
            per_file = {}
            for k in grp:
                f = nodes[k].fileIdx
                cur = (nodes[k].supp, nodes[k].ac)
                if f not in per_file or per_file[f][1] < cur[1]:
                    per_file[f] = cur
            supp = sum(v[0] for v in per_file.values())
            if supp < 1:
                continue
            if not retain_allele(cfg, nodes[rep], supp):
                continue
            kept_groups.append(grp)
            rep_idx.append(rep)

        n_allele = len(kept_groups)
        if n_allele == 0:
            continue
        locus_id = cfg.allele_counter
        cfg.allele_counter += 1
        for grp, rep in zip(kept_groups, rep_idx):
            per_file = {}
            cipos_lo = cipos_hi = ciend_lo = ciend_hi = 0
            for k in grp:
                f = nodes[k].fileIdx
                cur = (nodes[k].supp, nodes[k].ac)
                if f not in per_file or per_file[f][1] < cur[1]:
                    per_file[f] = cur
                d_pos = nodes[k].svStart - nodes[rep].svStart
                d_end = nodes[k].svEnd - nodes[rep].svEnd
                cipos_lo = min(cipos_lo, d_pos)
                cipos_hi = max(cipos_hi, d_pos)
                ciend_lo = min(ciend_lo, d_end)
                ciend_hi = max(ciend_hi, d_end)
            supp = sum(v[0] for v in per_file.values())
            ac = sum(v[1] for v in per_file.values())
            agg = MergeAgg(ac=ac, an=max(2 * cfg.total_samples, ac),
                           supp=supp, ciposLo=cipos_lo, ciposHi=cipos_hi,
                           ciendLo=ciend_lo, ciendHi=ciend_hi,
                           alleleId=locus_id, nAllele=n_allele)
            selected[(nodes[rep].fileIdx, nodes[rep].id)] = agg
            if out_groups is not None:
                out_groups.append((rep, grp, agg))
    return selected


def synth_consensus(fasta, chrom: str, svt: int, sv_start0: int,
                    rsv_end: int, ins_seq: str):
    """Flank-based consensus synthesis for external callers
    (merge.h:849-878). Returns (consensus, cons_bp, ins_len) or None."""
    flank = 600
    if fasta is None or svt not in (2, 4):
        return None
    if not fasta.has_seq(chrom):
        return None
    chrlen = fasta.lengths[chrom]
    lbeg = max(0, sv_start0 - flank + 1)
    lend = sv_start0
    rbeg = sv_start0 + 1 if svt == 4 else rsv_end
    rend = min(chrlen - 1, rbeg + flank - 1)
    if lend < lbeg or lend >= chrlen or rbeg < 0 or rbeg > rend:
        return None
    left = fasta.fetch(chrom, lbeg, lend + 1).upper()
    right = fasta.fetch(chrom, rbeg, rend + 1).upper()
    if not left or not right:
        return None
    ins = ins_seq.upper() if svt == 4 else ""
    return left + ins + right, len(left), len(ins)


SITE_HEADER_EXTRA = [
    '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency (AC/AN)">',
    '##INFO=<ID=SUPP,Number=1,Type=Integer,Description="Number of carrier samples">',
]


def _site_header_lines():
    from delly_tpu_torch.io.vcf import HEADER_LINES
    keep = [h for h in HEADER_LINES if "##FORMAT" not in h]
    return keep + SITE_HEADER_EXTRA


def _sorted_stream(readers: list, contig_map: dict, svtin: int = None):
    """k-way position-sorted stream over per-file parsed records,
    yielding (file_idx, rec) (merge.h:1010-1016). With `svtin`, streams
    only that SV type's records via the per-reader buckets built by
    collect_svtype (order within each file is preserved)."""
    heap = []
    if svtin is None:
        iters = [iter(r.records) for r in readers]
    elif all(hasattr(r, "_svt_buckets") for r in readers):
        iters = [iter(r._svt_buckets.get(svtin, ())) for r in readers]
    else:
        def _flt(rd):
            for rec in rd.records:
                info = rec["info"]
                svt_str = info.get("SVTYPE")
                if svt_str is None:
                    continue
                ct = info.get("CT")
                if merge_decode_svt(
                        str(svt_str),
                        str(ct) if ct is not None else None) == svtin:
                    yield rec
        iters = [_flt(r) for r in readers]
    for fi, it in enumerate(iters):
        rec = next(it, None)
        if rec is not None:
            heap.append((contig_map.get(rec["chrom"], 1 << 30), rec["pos"],
                         fi, rec))
    heapq.heapify(heap)
    while heap:
        _, _, fi, rec = heapq.heappop(heap)
        yield fi, rec
        nxt = next(iters[fi], None)
        if nxt is not None:
            heapq.heappush(heap, (contig_map.get(nxt["chrom"], 1 << 30),
                                  nxt["pos"], fi, nxt))


def emit_selected(cfg: MergeConfig, svtin: int, contig_map: dict,
                  readers: list, selected: dict, outfile: str,
                  fasta=None) -> None:
    """Pass 2: write merged site list (merge.h:881-1214)."""
    stage("Writing merged SV sites")
    names = [None] * len(contig_map)
    for name, tid in contig_map.items():
        names[tid] = name
    writer = VcfWriter(outfile, names, [0] * len(names), [],
                       header_lines=_site_header_lines(), format_keys=[])

    for fi, rec in _sorted_stream(readers, contig_map, svtin=svtin):
        key = (fi, rec["id"])
        agg = selected.get(key)
        if agg is None:
            continue
        info_in = rec["info"]
        recsvt = svtin
        chrom = rec["chrom"]
        sv_start = rec["pos"] - 1
        sv_end = _info_int(info_in, "END", sv_start + 1)
        inslen = _info_int(info_in, "INSLEN")
        if inslen == 0:
            inslen = abs(_info_int(info_in, "SVLEN"))
        precise = "PRECISE" in info_in
        pe = _info_int(info_in, "PE")
        sr = _info_int(info_in, "SR")
        mapq = _info_int(info_in, "MAPQ")
        srmapq = _info_int(info_in, "SRMAPQ")
        homlen = _info_int(info_in, "HOMLEN")
        srq = _info_float(info_in, "SRQ")
        chr2_name = chrom
        pos2 = 0
        if "CHR2" in info_in:
            chr2_name = str(info_in["CHR2"])
            pos2 = _info_int(info_in, "POS2")
        elif svtin >= SVT_TRANS:
            mate = parse_bnd_mate(rec["alt"])
            if mate:
                chr2_name, pos2 = mate
        cons = ""
        ce = 0.0
        cons_bp = 0
        if precise:
            ce = _info_float(info_in, "CE")
            cons = str(info_in.get("CONSENSUS", "")).upper()
            cons_bp = _info_int(info_in, "CONSBP")
        sub = str(info_in.get("SUBTYPE", ""))
        ins_strand = str(info_in.get("INSSTRAND", ""))
        trp = info_in.get("TRPERIOD")
        trc = info_in.get("TRCOPIES")

        # Synthesize consensus for external callers (merge.h:1067-1088)
        if fasta is not None and not cons and svtin in (2, 4):
            ins_seq = ""
            can_synth = True
            if svtin == 4:
                alt_in = rec["alt"]
                if alt_in and alt_in[0] != "<" and len(alt_in) > 1:
                    ins_seq = alt_in[1:]
                else:
                    can_synth = False
            if can_synth:
                rsv_end = sv_start + 1 if svtin == 4 else sv_end
                synth = synth_consensus(fasta, chrom, svtin, sv_start,
                                        rsv_end, ins_seq)
                if synth:
                    cons, cons_bp, inslen = synth
                    precise = True
                    ce = entropy(cons)
                    if svtin == 4:
                        sv_end = rsv_end

        if len(cfg.files) == 1:
            vid = rec["id"]
        else:
            vid = f"{add_id(svtin)}{cfg.svcounter:08d}"
            cfg.svcounter += 1
        ref_allele = rec["ref"]
        # htslib n_allele == 1 when ALT is missing ('.') — the
        # reference then substitutes the symbolic allele (merge.h:1098)
        alt_allele = (rec["alt"] if rec["alt"] and rec["alt"] != "."
                      else f"<{add_id(svtin)}>")

        info = []
        info.append(("PRECISE" if precise else "IMPRECISE", None))
        info.append(("SVTYPE", add_id(svtin)))
        info.append(("SVMETHOD", SVMETHOD))
        info.append(("END", sv_end))
        if svtin >= SVT_TRANS:
            info.append(("CHR2", chr2_name))
            info.append(("POS2", pos2))
        if svtin < SVT_TRANS:
            if svtin == 4:
                svlen = inslen
            elif svtin == 2:
                svlen = sv_start - sv_end
            else:
                svlen = sv_end - sv_start
            info.append(("SVLEN", svlen))
        info.append(("PE", pe))
        info.append(("MAPQ", mapq))
        info.append(("CT", add_orientation(svtin)))
        info.append(("CIPOS", f"{agg.ciposLo},{agg.ciposHi}"))
        info.append(("CIEND", f"{agg.ciendLo},{agg.ciendHi}"))
        if precise:
            info.append(("SRMAPQ", srmapq))
            info.append(("INSLEN", inslen))
            info.append(("HOMLEN", homlen))
            info.append(("SR", sr))
            info.append(("SRQ", fmt_float(srq)))
            if cons:
                info.append(("CONSENSUS", cons))
                info.append(("CE", fmt_float32(ce)))
                info.append(("CONSBP", cons_bp))
        if sub:
            info.append(("SUBTYPE", sub))
        if ins_strand:
            info.append(("INSSTRAND", ins_strand))
        if trp is not None:
            info.append(("TRPERIOD", trp))
        if trc is not None:
            # the reference round-trips TRCOPIES through a BCF float
            # (merge.h:1065,1158), so "32.0" re-renders as "32"
            try:
                info.append(("TRCOPIES",
                             fmt_float32(str(trc))))
            except ValueError:
                info.append(("TRCOPIES", trc))
        # float32 division like the reference's (float)ac / (float)an
        # (merge.h:1168) — the 6-digit rendering can differ from f64
        # near rounding boundaries
        af = (float(_np.float32(agg.ac) / _np.float32(agg.an))
              if agg.an > 0 else 0.0)
        info.append(("AC", agg.ac))
        info.append(("AN", agg.an))
        info.append(("AF", fmt_float32(af)))
        info.append(("SUPP", agg.supp))
        info.append(("ALLELEID", agg.alleleId))
        info.append(("NALLELE", agg.nAllele))

        writer.write_record(chrom, sv_start + 1, vid, ref_allele,
                            alt_allele, rec["qual"], "PASS", info, [])
    writer.close()


# --- CNV interval merging (merge.h:1449-1582) ---

@dataclass
class IntervalScore:
    start: int
    end: int
    score: int
    cn: int = 2
    srl: int = 0
    srr: int = 0
    uniq: float = -1.0
    suppLoss: int = 0
    suppGain: int = 0

    def precise(self) -> bool:
        return self.srl > 0 and self.srr > 0


def fill_cnv_interval_map(cfg: MergeConfig, contig_map: dict,
                          readers: list) -> list:
    """merge.h:1471-1523."""
    iscore = [[] for _ in range(len(contig_map))]
    for rdr in readers:
        for rec in rdr.records:
            info = rec["info"]
            if cfg.filter_for_pass and rec["filter"] != "PASS":
                continue
            if str(info.get("SVTYPE")) != "CNV":
                continue
            tid = contig_map[rec["chrom"]]
            sv_start = rec["pos"] - 1
            sv_end = _info_int(info, "END", sv_start + 2)
            if (sv_end - sv_start < cfg.minsize
                    or sv_end - sv_start > cfg.maxsize):
                continue
            precise = "PRECISE" in info
            if cfg.filter_for_precise and not precise:
                continue
            q = _rec_qual(rec)
            ivs = IntervalScore(sv_start, sv_end, int(q) if q == q else 0)
            samples = rec.get("samples", [])
            if samples and "CN" in samples[0]:
                try:
                    ivs.cn = int(samples[0]["CN"])
                except ValueError:
                    pass
            ivs.srl = _info_int(info, "SRL")
            ivs.srr = _info_int(info, "SRR")
            ivs.uniq = _info_float(info, "UNIQ", -1.0)
            iscore[tid].append(ivs)
    for chrom in iscore:
        chrom.sort(key=lambda v: (v.start, v.end))
    return iscore


def process_cnv_interval_map(cfg: MergeConfig, iscore: list) -> list:
    """merge.h:1526-1582."""
    iselected = [[] for _ in iscore]
    for seq_id, chrom in enumerate(iscore):
        n = len(chrom)
        used = [False] * n
        for i in range(n):
            if used[i]:
                continue
            lead = chrom[i]
            rep_idx = i
            supp_loss = supp_gain = 0
            precise_loss = precise_gain = False
            best_uniq = -1.0
            best_srl = best_srr = 0
            for j in range(i, n):
                if used[j]:
                    continue
                cur = chrom[j]
                if cur.start - lead.start > cfg.bpoffset:
                    break
                if j != i:
                    end_close = abs(cur.end - lead.end) < cfg.bpoffset
                    if (not end_close
                            or rec_overlap(lead.start, lead.end, cur.start,
                                           cur.end) < cfg.recoverlap):
                        continue
                used[j] = True
                if cur.cn < 2:
                    supp_loss += 1
                    if cur.precise():
                        precise_loss = True
                elif cur.cn > 2:
                    supp_gain += 1
                    if cur.precise():
                        precise_gain = True
                if cur.uniq > best_uniq:
                    best_uniq = cur.uniq
                if cur.srl > best_srl:
                    best_srl = cur.srl
                if cur.srr > best_srr:
                    best_srr = cur.srr
                if cur.score > chrom[rep_idx].score:
                    rep_idx = j
            rep = chrom[rep_idx]
            size = rep.end - rep.start
            loss_ok = (supp_loss >= cfg.recurrent_samples or precise_loss
                       or size >= cfg.cnv_large_size
                       or (rep.score >= cfg.qualthres
                           and best_uniq >= cfg.cnv_min_uniq))
            gain_ok = precise_gain or (supp_gain >= cfg.recurrent_samples
                                       and best_uniq >= cfg.cnv_gain_uniq)
            if loss_ok or gain_ok:
                keep = IntervalScore(rep.start, rep.end, rep.score)
                keep.suppLoss = supp_loss
                keep.suppGain = supp_gain
                keep.srl = best_srl
                keep.srr = best_srr
                keep.uniq = best_uniq
                iselected[seq_id].append(keep)
        iselected[seq_id].sort(key=lambda v: (v.start, v.end))
    return iselected


CNV_SITE_HEADER = [
    '##ALT=<ID=CNV,Description="copy-number variants">',
    '##FILTER=<ID=LowQual,Description="Poor quality copy-number variant">',
    '##INFO=<ID=CIEND,Number=2,Type=Integer,Description="Confidence interval around END">',
    '##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the copy-number variant">',
    '##INFO=<ID=MP,Number=1,Type=Float,Description="Mappable fraction of CNV">',
    '##INFO=<ID=UNIQ,Number=1,Type=Float,Description="Uniquely-mappable fraction">',
    '##INFO=<ID=SRL,Number=1,Type=Integer,Description="Split-read support at the left breakpoint">',
    '##INFO=<ID=SRR,Number=1,Type=Integer,Description="Split-read support at the right breakpoint">',
    '##INFO=<ID=SUPPLOSS,Number=1,Type=Integer,Description="Number of samples supporting a loss">',
    '##INFO=<ID=SUPPGAIN,Number=1,Type=Integer,Description="Number of samples supporting a gain">',
    '##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise copy-number variant">',
    '##INFO=<ID=PRECISE,Number=0,Type=Flag,Description="Precise copy-number variant">',
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
    '##INFO=<ID=SVMETHOD,Number=1,Type=String,Description="Type of approach used to detect CNV">',
]


def output_selected_cnv_intervals(cfg: MergeConfig, iselected: list,
                                  contig_map: dict, readers: list,
                                  outfile: str) -> None:
    """merge.h:1218-1445."""
    stage("Filtering SVs")
    names = [None] * len(contig_map)
    for name, tid in contig_map.items():
        names[tid] = name
    writer = VcfWriter(outfile, names, [0] * len(names), [],
                       header_lines=CNV_SITE_HEADER, format_keys=[])
    gis = [set() for _ in range(len(contig_map))]
    _iv_starts: dict = {}
    for fi, rec in _sorted_stream(readers, contig_map):
        info_in = rec["info"]
        if str(info_in.get("SVTYPE")) != "CNV":
            continue
        if cfg.filter_for_pass and rec["filter"] != "PASS":
            continue
        precise_in = "PRECISE" in info_in
        if cfg.filter_for_precise and not precise_in:
            continue
        tid = contig_map[rec["chrom"]]
        sv_start = rec["pos"] - 1
        sv_end = _info_int(info_in, "END", sv_start + 1)
        if (sv_end - sv_start < cfg.minsize
                or sv_end - sv_start > cfg.maxsize):
            continue
        q = _rec_qual(rec)
        score = int(q) if q == q else 0
        found = None
        # lower_bound on the sorted interval starts (merge.h:1342) —
        # a from-zero scan is O(records x intervals) per chromosome
        ivs = iselected[tid]
        starts = _iv_starts.get(tid)
        if starts is None or len(starts) != len(ivs):
            starts = [iv.start for iv in ivs]
            _iv_starts[tid] = starts
        import bisect as _bisect
        for k in range(_bisect.bisect_left(starts, sv_start), len(ivs)):
            iv = ivs[k]
            if iv.start > sv_start:
                break
            if (iv.start == sv_start and iv.end == sv_end
                    and iv.score == score):
                if (sv_start, sv_end) not in gis[tid]:
                    found = iv
                    gis[tid].add((sv_start, sv_end))
                break
        if found is None:
            continue
        precise = found.srl > 0 and found.srr > 0
        if len(cfg.files) == 1:
            vid = rec["id"]
        else:
            vid = f"CNV{cfg.svcounter:08d}"
            cfg.svcounter += 1
        info = []
        info.append(("PRECISE" if precise else "IMPRECISE", None))
        info.append(("SVTYPE", "CNV"))
        info.append(("SVMETHOD", SVMETHOD))
        info.append(("END", sv_end))
        info.append(("CIPOS", info_in.get("CIPOS", "-50,50")))
        info.append(("CIEND", info_in.get("CIEND", "-50,50")))
        info.append(("MP", info_in.get("MP", 0)))
        info.append(("UNIQ", fmt_float32(found.uniq)))
        info.append(("SRL", found.srl))
        info.append(("SRR", found.srr))
        info.append(("SUPPLOSS", found.suppLoss))
        info.append(("SUPPGAIN", found.suppGain))
        writer.write_record(rec["chrom"], sv_start + 1, vid, rec["ref"],
                            rec["alt"], rec["qual"], "PASS", info, [])
    writer.close()


def regroup_loci(cfg: MergeConfig, site_files: list):
    """TR/VNTR and compound-het locus regrouping across the per-type
    site lists (merge.h:1585-1729). Returns (new_aid, new_nal)."""
    als = []  # (rid_name, pos, end, svt, ac, trperiod, tr, f, k)
    new_aid = []
    new_nal = []
    readers = [VcfReader(f) for f in site_files]
    # contig order from the headers (rid order, like merge_bcfs)
    contig_map = {}
    for rdr in readers:
        for name in rdr.contig_names():
            if name not in contig_map:
                contig_map[name] = len(contig_map)
    for rdr in readers:
        for rec in rdr.records:
            if rec["chrom"] not in contig_map:
                contig_map[rec["chrom"]] = len(contig_map)
    for f, rdr in enumerate(readers):
        new_aid.append([-1] * len(rdr.records))
        new_nal.append([1] * len(rdr.records))
        for k, rec in enumerate(rdr.records):
            info = rec["info"]
            end = _info_int(info, "END", rec["pos"])
            svt_s = str(info.get("SVTYPE", ""))
            svt = {"DEL": 2, "INS": 4, "DUP": 3, "INV": 0}.get(svt_s, 5)
            tr = "TR" in str(info.get("SUBTYPE", ""))
            trperiod = _info_int(info, "TRPERIOD")
            if trperiod > 0:
                tr = True
            ac = _info_int(info, "AC")
            als.append([contig_map.get(rec["chrom"], 0), rec["pos"] - 1,
                        end, svt, ac, trperiod, tr, f, k])

    n = len(als)
    if n == 0:
        return new_aid, new_nal
    ord_idx = sorted(range(n), key=lambda i: (als[i][0], als[i][1]))
    uf = UnionFind(n)
    two_n = 2.0 * cfg.total_samples
    sweep_cap = max(cfg.bpoffset, 5000)
    max_span = 10000
    comp_min = [a[1] for a in als]
    comp_max = [a[1] for a in als]

    def try_unite(i, j):
        ri, rj = uf.find(i), uf.find(j)
        if ri == rj:
            return
        mn = min(comp_min[ri], comp_min[rj])
        mx = max(comp_max[ri], comp_max[rj])
        if mx - mn > max_span:
            return
        uf.unite(i, j)
        r = uf.find(i)
        comp_min[r] = mn
        comp_max[r] = mx

    for oi in range(n):
        i = ord_idx[oi]
        for oj in range(oi - 1, -1, -1):
            j = ord_idx[oj]
            if als[j][0] != als[i][0]:
                break
            if als[i][1] - als[j][1] > sweep_cap:
                break
            overlap = als[i][1] <= als[j][2] and als[j][1] <= als[i][2]
            if als[i][6] and als[j][6]:
                w = max(cfg.bpoffset, 2 * max(als[i][5], als[j][5]))
                if als[i][1] - als[j][1] <= w or overlap:
                    try_unite(i, j)
            elif als[i][6] or als[j][6]:
                non_span = (als[j][2] - als[j][1] if als[i][6]
                            else als[i][2] - als[i][1])
                if overlap and non_span <= max_span:
                    try_unite(i, j)
            elif als[i][3] == als[j][3]:
                if overlap:
                    e = (als[i][4] * als[j][4] / two_n) if two_n > 0 else 0.0
                    if e >= 1.0:
                        try_unite(i, j)

    root_count = {}
    for i in range(n):
        r = uf.find(i)
        root_count[r] = root_count.get(r, 0) + 1
    root_id = {}
    counter = 1
    for i in range(n):
        r = uf.find(i)
        if r not in root_id:
            root_id[r] = counter
            counter += 1
        new_aid[als[i][7]][als[i][8]] = root_id[r]
        new_nal[als[i][7]][als[i][8]] = root_count[r]
    return new_aid, new_nal


def merge_bcfs(cfg: MergeConfig, site_files: list, outfile: str) -> None:
    """k-way merge of the per-type site lists with ALLELEID relabeling
    (merge.h:1731-1819)."""
    stage("Merging SV types")
    new_aid, new_nal = regroup_loci(cfg, site_files)
    readers = [VcfReader(f) for f in site_files]
    # header contig order (the reference merges by rid,
    # merge.h:1776-1780) — record-appearance order could interleave
    # contigs when per-type files cover different chromosome sets
    contig_map = {}
    for rdr in readers:
        for name in rdr.contig_names():
            if name not in contig_map:
                contig_map[name] = len(contig_map)
    for rdr in readers:
        for rec in rdr.records:
            if rec["chrom"] not in contig_map:
                contig_map[rec["chrom"]] = len(contig_map)
    # Output header duplicated from the first per-type file
    out_lines = []
    hdr = readers[0].header_lines
    kcount = [0] * len(site_files)
    body = []
    for fi, rec in _sorted_stream(readers, contig_map):
        rk = kcount[fi]
        kcount[fi] += 1
        raw = rec["_raw"]
        if rk < len(new_aid[fi]) and new_aid[fi][rk] > 0:
            # Relabel ALLELEID / NALLELE in the INFO column
            cols = raw.split("\t")
            items = cols[7].split(";")
            for idx, item in enumerate(items):
                if item.startswith("ALLELEID="):
                    items[idx] = f"ALLELEID={new_aid[fi][rk]}"
                elif item.startswith("NALLELE="):
                    items[idx] = f"NALLELE={new_nal[fi][rk]}"
            cols[7] = ";".join(items)
            raw = "\t".join(cols)
        body.append(raw)
    _write_vcf_text(outfile, hdr, readers[0].column_header, body)
    stage("Done.")


def _write_vcf_text(path: str, header_lines: list, column_header: str,
                    body: list) -> None:
    lines = list(header_lines)
    if not any(h.startswith("##fileformat") for h in lines):
        lines.insert(0, "##fileformat=VCFv4.2")
    text = "\n".join(lines + [column_header] + body)
    if body:
        text += "\n"
    if path == "-":
        sys.stdout.write(text)
    elif path.endswith(".bcf"):
        from delly_tpu_torch.io.bcf import vcf_text_to_bcf
        from delly_tpu_torch.io.csi import build_csi
        bcf_bytes, n_ref, rec_meta = vcf_text_to_bcf(text,
                                                     with_index=True)
        with open(path, "wb") as fh:
            fh.write(bcf_bytes)
        with open(path + ".csi", "wb") as fh:
            fh.write(build_csi(bcf_bytes, n_ref, rec_meta))
    elif path.endswith(".gz"):
        from delly_tpu_torch.io.bgzf import bgzf_compress
        with open(path, "wb") as fh:
            fh.write(bgzf_compress(text.encode()))
    else:
        with open(path, "w") as fh:
            fh.write(text)


_reader_cache: dict = {}


def _get_readers(files: list) -> list:
    """Inputs are parsed once and reused across the per-SV-type merge
    passes (the reference re-reads the BCFs per type; parsing is the
    dominant cost of our text layer)."""
    out = []
    for f in files:
        if f not in _reader_cache:
            _reader_cache[f] = VcfReader(f)
        out.append(_reader_cache[f])
    return out


def merge_run(cfg: MergeConfig, svt: int, outfile: str) -> int:
    """merge.h:1821-1871."""
    readers = _get_readers(cfg.files)
    contig_map = {}
    for rdr in readers:
        for name in rdr.contig_names():
            if name not in contig_map:
                contig_map[name] = len(contig_map)
    if svt == 9:
        iscore = fill_cnv_interval_map(cfg, contig_map, readers)
        iselected = process_cnv_interval_map(cfg, iscore)
        output_selected_cnv_intervals(cfg, iselected, contig_map, readers,
                                      outfile)
    else:
        nodes = collect_svtype(cfg, svt, contig_map, readers)
        selected = cluster_and_select(cfg, nodes)
        fasta = None
        if cfg.genome:
            from delly_tpu_torch.io.fasta import FastaFile
            fasta = FastaFile(cfg.genome)
        emit_selected(cfg, svt, contig_map, readers, selected, outfile,
                      fasta)
    stage("Done.")
    return 0


def run_merge(cfg: MergeConfig) -> int:
    """merge.h:1873-2116 (including chunked merging)."""
    # Single file: VCF or list of files?
    if len(cfg.files) == 1:
        path = cfg.files[0]
        try:
            VcfReader(path)
        except Exception:
            stage("Assuming input is a list of BCF files")
            with open(path) as fh:
                cfg.files = [ln.strip() for ln in fh if ln.strip()]
    cfg.total_samples = len(cfg.files)
    if cfg.chunksize < 100:
        cfg.chunksize = 100
    if len(cfg.files) > cfg.chunksize:
        best_chunk = cfg.chunksize
        best_bin = 0
        for i in range(50, cfg.chunksize):
            chunks = (len(cfg.files) - 1) // i
            last_bin = len(cfg.files) - chunks * i
            if last_bin > best_bin:
                best_bin = last_bin
                best_chunk = i
        cfg.chunksize = best_chunk

    min_svt, max_svt = (9, 10) if cfg.cnv_mode else (0, 9)
    tmpdir = tempfile.mkdtemp(prefix="delly_merge_")
    svt_collect = {}
    all_files = list(cfg.files)
    for svt in range(min_svt, max_svt):
        svt_out = os.path.join(tmpdir, f"svt{svt}.vcf")
        svt_collect[svt] = svt_out
        if len(all_files) <= cfg.chunksize:
            cfg.files = all_files
            merge_run(cfg, svt, svt_out)
        else:
            chunks = (len(all_files) - 1) // cfg.chunksize + 1
            chunk_files = []
            for ic in range(chunks):
                chunk_out = os.path.join(tmpdir, f"svt{svt}_chunk{ic}.vcf")
                cfg.files = all_files[ic * cfg.chunksize:
                                      (ic + 1) * cfg.chunksize]
                merge_run(cfg, svt, chunk_out)
                chunk_files.append(chunk_out)
            # Re-merge the chunk site lists with VAF/coverage gating off
            vaf_store, cov_store = cfg.vaf, cfg.coverage
            cfg.vaf = 0.0
            cfg.coverage = 0
            cfg.files = chunk_files
            merge_run(cfg, svt, svt_out)
            cfg.vaf, cfg.coverage = vaf_store, cov_store
            for f in chunk_files:
                os.remove(f)
    cfg.files = all_files

    if cfg.cnv_mode:
        with open(svt_collect[9]) as src:
            data = src.read()
        lines = data.split("\n")
        hdr = [l for l in lines if l.startswith("##")]
        col = next((l for l in lines if l.startswith("#CHROM")), "#CHROM")
        body = [l for l in lines if l and not l.startswith("#")]
        _write_vcf_text(cfg.outfile, hdr, col, body)
    else:
        merge_bcfs(cfg, [svt_collect[s] for s in range(min_svt, max_svt)],
                   cfg.outfile)
    for f in svt_collect.values():
        if os.path.exists(f):
            os.remove(f)
    os.rmdir(tmpdir)
    _reader_cache.clear()
    return 0

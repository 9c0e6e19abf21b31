"""Read-depth segmentation and CNV calling.

Reference: src/cnv.h — split-read breakpoint candidates with flanking
CN-shift z-tests (collectBreakpoints), log2-ratio window profiles with a
MAD-of-diffs noise estimate, penalized optimal-partition segmentation
with pruning (PELT-like, cnvSegment), split-read boundary fusion,
iterative neighbor merging, per-CNV genotyping (CN / mappable fraction /
uniq fraction / SD), same-CN merging, and CNV BCF emission with CN0..CN9
likelihoods.

The window profile and flank-z construction run through native
sequential accumulators (hostio rd_windows / rd_flank_z) because the
reference resets its running float sums at every window close — any
vectorized cumsum differs in the last ulp and shifts a boundary or a CN
digit (pinned by tests/test_cnv_oracle.py). The sequential penalized DP
stays on the host (small N, data-dependent pruning).
"""

from __future__ import annotations

import math

from dataclasses import dataclass

import numpy as np

from delly_tpu_torch import native

from delly_tpu_torch.io.vcf import VcfReader, VcfWriter, fmt_float, fmt_float32
from delly_tpu_torch.ops.likelihood import compute_cnls
from delly_tpu_torch.version import SVMETHOD
from delly_tpu_torch.utils.log import stage
from delly_tpu_torch.utils.stats import iround


@dataclass
class CNV:
    """util.h:42-66."""
    chr: int = 0
    start: int = 0
    end: int = 0
    ciposlow: int = 0
    ciposhigh: int = 0
    ciendlow: int = 0
    ciendhigh: int = 0
    qval: int = 0
    srleft: int = 0
    srright: int = 0
    cn: float = -1.0
    mappable: float = 0.0
    uniqfrac: float = -1.0
    sd: float = 1.0
    id: str = ""

    def sort_key(self):
        return (self.chr, self.start, self.end, self.cn)


def uniq_threshold(cfg) -> float:
    """The uniqueness threshold `c.fragmentUnique * c.meanisize` is a
    FLOAT product in the reference (CountDNAConfig.fragmentUnique is
    float, coral.h:60; usual conversions make the whole comparison
    float32) — a float64 0.97*300 lands one ulp BELOW 291 while the
    reference's float32 product lands above it, flipping any position
    whose uniqContent sits exactly on the boundary."""
    return float(np.float32(cfg.fragment_unique)
                 * np.float32(cfg.meanisize))


@dataclass
class SVBreakpoint:
    """cnv.h:34-47."""
    pos: int
    cilow: int = 0
    cihigh: int = 0
    qual: int = 0
    support: int = 0


def collect_breakpoints(cfg, gcbound, gc_content, uniq_content, gcbias,
                        cov, reflen: int, clips: list) -> list:
    """Clip clusters + flanking CN-shift z-test (cnv.h:63-134)."""
    chrbp = []
    if not clips:
        return chrbp
    bp_tol = 2 * cfg.min_clip
    flank_exp_target = cfg.target_exp_cov if cfg.target_exp_cov > 0 else 1000.0
    max_flank = 1000000
    min_cn_shift = 0.5
    r_floor = 1.0 / 64.0
    sub_exp = flank_exp_target / 8.0

    cov_curve = np.asarray([gb.coverage for gb in gcbias])
    valid = ((gc_content > gcbound[0]) & (gc_content < gcbound[1])
             & (uniq_content >= uniq_threshold(cfg)))
    vpos = np.nonzero(valid)[0]
    vcov = cov[vpos].astype(np.float64)
    vexp = cov_curve[gc_content[vpos].astype(np.int64)]

    def _flank_seq(c_arr, e_arr):
        # pure-Python fallback, reference op order (cnv.h:88-110)
        z = []
        covsum = expcov = 0.0
        for k in range(len(c_arr)):
            if len(z) >= 8:
                break
            covsum += float(c_arr[k])
            expcov += float(e_arr[k])
            if expcov >= sub_exp:
                z.append(math.log2(max(covsum / expcov, r_floor)))
                covsum = expcov = 0.0
        return z

    def flank_z(bppos, left: bool):
        """Up to 8 sub-windows of >= subExp expected coverage,
        accumulated sequentially in walk order (cnv.h:88-110)."""
        if left:
            hi = int(np.searchsorted(vpos, bppos, side="left"))
            lo = int(np.searchsorted(vpos, bppos - max_flank,
                                     side="left"))
            c_arr = vcov[lo:hi][::-1]
            e_arr = vexp[lo:hi][::-1]
        else:
            lo = int(np.searchsorted(vpos, bppos, side="left"))
            hi = int(np.searchsorted(vpos, bppos + max_flank,
                                     side="left"))
            c_arr = vcov[lo:hi]
            e_arr = vexp[lo:hi]
        z = native.rd_flank_z(c_arr, e_arr, sub_exp)
        if z is None:
            z = _flank_seq(c_arr, e_arr)
        return z

    # cluster boundaries wherever the gap between consecutive sorted
    # clips exceeds bp_tol (same chaining as the scalar walk)
    ca = np.sort(np.asarray(clips, dtype=np.int64))
    brk = np.nonzero(np.diff(ca) > bp_tol)[0]
    cl_start = np.concatenate(([0], brk + 1))
    cl_end = np.concatenate((brk + 1, [len(ca)]))
    cl_support = cl_end - cl_start
    csum = np.concatenate(([0], np.cumsum(ca)))
    cl_possum = csum[cl_end] - csum[cl_start]
    for k in np.nonzero(cl_support >= cfg.min_bp_support)[0]:
        support = int(cl_support[k])
        bppos = int(cl_possum[k]) // support
        zl = flank_z(bppos, True)
        zr = flank_z(bppos, False)
        if len(zl) >= 2 and len(zr) >= 2:
            # sequential accumulation + std::exp2, cnv.h:112-125
            ml = 0.0
            for v in zl:
                ml += v
            ml /= len(zl)
            mr = 0.0
            for v in zr:
                mr += v
            mr /= len(zr)
            ss = 0.0
            for v in zl:
                ss += (v - ml) * (v - ml)
            for v in zr:
                ss += (v - mr) * (v - mr)
            sd = math.sqrt(ss / (len(zl) + len(zr) - 2))
            se = sd * math.sqrt(1.0 / len(zl) + 1.0 / len(zr))
            cn_l = cfg.ploidy * math.exp2(ml)
            cn_r = cfg.ploidy * math.exp2(mr)
            if abs(cn_l - cn_r) >= min_cn_shift and abs(mr - ml) >= 3 * se:
                qual = 50 + min(support, 40)
                chrbp.append(SVBreakpoint(bppos, -bp_tol, bp_tol, qual,
                                          support))
    chrbp.sort(key=lambda b: (b.pos, b.qual))
    return chrbp


def cnv_segment(y: np.ndarray, beta: float, kmin: int) -> list:
    """Penalized optimal-partition segmentation with pruning
    (cnv.h:237-291). Returns internal boundary indices."""
    n = len(y)
    if n < 2 * kmin:
        return []
    try:
        from delly_tpu_torch import native
        got = native.cnv_segment_core(y, beta, kmin)
        if got is not None:
            return got
    except Exception:
        pass
    s1 = np.concatenate(([0.0], np.cumsum(y)))
    s2 = np.concatenate(([0.0], np.cumsum(y * y)))
    f = np.zeros(n + 1)
    prev = np.zeros(n + 1, dtype=np.int64)
    f[0] = -beta
    r_set = []
    for t in range(kmin, n + 1):
        if t == kmin or t >= 2 * kmin:
            r_set.append(t - kmin)
        rs = np.asarray(r_set, dtype=np.int64)
        nn = t - rs
        sm = s1[t] - s1[rs]
        cost = f[rs] + ((s2[t] - s2[rs]) - sm * sm / nn)
        vals = cost + beta
        bi = int(np.argmin(vals))
        f[t] = vals[bi]
        prev[t] = rs[bi]
        keep = cost <= f[t]
        r_set = [int(s) for s in rs[keep]]
    rev = []
    t = n
    while t > 0:
        s = int(prev[t])
        if s > 0:
            rev.append(s)
        if s >= t:
            break
        t = s
    return rev[::-1]


@dataclass
class _Boundary:
    w: int
    bp: int = -1
    sr: int = 0


def segment_rd(cfg, gcbound, gc_content, uniq_content, gcbias, tile_fac,
               reg_win, cov, reflen: int, ref_index: int, chrbp: list,
               cnvs: list) -> None:
    """Log2-ratio profile + segmentation + SR fusion + neighbor merging
    (cnv.h:294-459)."""
    kmin = 4
    bp_tol = 2 * cfg.min_clip
    pcf_target_exp = cfg.target_exp_cov if cfg.target_exp_cov > 0 else 0.0
    pcf_win_bases = (cfg.window_size if cfg.window_size > 0
                     else max(1, cfg.min_cnv_size))
    r_floor = 1.0 / 64.0

    cov_curve = np.asarray([gb.coverage for gb in gcbias])
    valid = ((gc_content > gcbound[0]) & (gc_content < gcbound[1])
             & (uniq_content >= uniq_threshold(cfg)))
    vpos = np.nonzero(valid)[0]
    if len(vpos) == 0:
        return
    vcov = cov[vpos].astype(np.float64)
    e1 = cov_curve[gc_content[vpos].astype(np.int64)]
    if len(tile_fac):
        ecor = e1 * tile_fac[vpos // reg_win]
    else:
        ecor = e1
    # Window profile: the reference accumulates covsum/expraw/expcor
    # sequentially and RESETS to zero at each window close
    # (cnv.h:307-350) — both the closure threshold (expraw >= target)
    # and the per-window float sums round differently under
    # cumsum/pairwise summation, so build the windows natively in the
    # identical order (pinned by tests/test_cnv_oracle.py).
    win = native.rd_windows(vpos, vcov, e1, ecor, pcf_target_exp,
                            pcf_win_bases)
    if win is None:  # pure-Python fallback, same op order
        ws_l, we_l, wcov_l, wexp_l, z_l = [], [], [], [], []
        covsum = expraw = expcor = 0.0
        winlen = 0
        start = -1
        for i in range(len(vpos)):
            if start < 0:
                start = int(vpos[i])
            covsum += float(vcov[i])
            expraw += float(e1[i])
            expcor += float(ecor[i])
            winlen += 1
            close = (expraw >= pcf_target_exp if pcf_target_exp > 0
                     else winlen >= pcf_win_bases)
            if close:
                r = covsum / expcor if expcor > 0 else 1.0
                z_l.append(math.log2(max(r, r_floor)))
                ws_l.append(start)
                we_l.append(int(vpos[i]) + 1)
                wcov_l.append(covsum)
                wexp_l.append(expcor)
                covsum = expraw = expcor = 0.0
                winlen = 0
                start = -1
        if winlen > 0 and start >= 0:  # trailing partial window flush
            r = covsum / expcor if expcor > 0 else 1.0
            z_l.append(math.log2(max(r, r_floor)))
            ws_l.append(start)
            we_l.append(int(vpos[-1]) + 1)
            wcov_l.append(covsum)
            wexp_l.append(expcor)
        ws = np.asarray(ws_l, dtype=np.int64)
        we = np.asarray(we_l, dtype=np.int64)
        wcov = np.asarray(wcov_l)
        wexp = np.asarray(wexp_l)
        z = np.asarray(z_l)
    else:
        ws, we, wcov, wexp, z = win
    n_w = len(z)
    if n_w < 1:
        return

    sigma = 0.02
    if n_w > 1:
        diff = np.sort(np.abs(np.diff(z)))
        sigma = float(diff[len(diff) // 2]) / 0.9539
    if sigma < 0.02:
        sigma = 0.02

    beta = cfg.penalty * sigma * sigma * math.log(max(n_w, 2))
    pcfbnd = cnv_segment(z, beta, kmin)

    bset = [_Boundary(0)] + [_Boundary(w) for w in pcfbnd] + [_Boundary(n_w)]

    # Fuse split-read breakpoints (cnv.h:378-402)
    for bp in chrbp:
        wi = int(np.searchsorted(ws, bp.pos, side="left"))
        if wi <= 0 or wi >= n_w:
            continue
        bi = 0
        for k in range(1, len(bset) - 1):
            if abs(bset[k].w - wi) < abs(bset[bi].w - wi):
                bi = k
        if bi > 0 and abs(bset[bi].w - wi) <= 1:
            bset[bi].w = wi
            bset[bi].bp = bp.pos
            bset[bi].sr = bp.support
        else:
            bset.append(_Boundary(wi, bp.pos, bp.support))
    bset.sort(key=lambda x: (x.w, -x.sr))
    dedup = []
    for x in bset:
        if dedup and dedup[-1].w == x.w:
            continue
        dedup.append(x)
    bset = dedup

    ns = len(bset) - 1
    # segcov is integer-valued (exact in any order); segexp sums
    # doubles sequentially like the reference's window loop
    # (cnv.h:409-414).  NOTE: builtin sum() must not be used here —
    # CPython 3.12+ compensates float sums (Neumaier), which rounds
    # differently from the reference's plain left-to-right loop.
    segcov = [float(wcov[bset[s].w:bset[s + 1].w].sum()) for s in range(ns)]
    segexp = []
    for s in range(ns):
        acc = 0.0
        for v in wexp[bset[s].w:bset[s + 1].w].tolist():
            acc += v
        segexp.append(acc)
    segnw = [bset[s + 1].w - bset[s].w for s in range(ns)]

    # Iterative neighbor merging (cnv.h:417-441)
    z_k = 3.0
    z_floor = cfg.cn_merge_tol
    while ns > 1:
        best = -1
        best_dz = 0.0
        for s in range(ns - 1):
            cn_l = (cfg.ploidy * segcov[s] / segexp[s]
                    if segexp[s] > 0 else cfg.ploidy)
            cn_r = (cfg.ploidy * segcov[s + 1] / segexp[s + 1]
                    if segexp[s + 1] > 0 else cfg.ploidy)
            dz = abs(math.log2(max(cn_l / cfg.ploidy, r_floor))
                     - math.log2(max(cn_r / cfg.ploidy, r_floor)))
            se = sigma * math.sqrt(1.0 / max(segnw[s], 1)
                                   + 1.0 / max(segnw[s + 1], 1))
            tol = max(z_floor, z_k * se)
            if dz < tol and (best < 0 or dz < best_dz):
                best = s
                best_dz = dz
        if best < 0:
            break
        s = best
        segcov[s] += segcov[s + 1]
        segexp[s] += segexp[s + 1]
        segnw[s] += segnw[s + 1]
        del bset[s + 1]
        del segcov[s + 1]
        del segexp[s + 1]
        del segnw[s + 1]
        ns -= 1

    for s in range(ns):
        wa, wb = bset[s].w, bset[s + 1].w
        if wb <= wa:
            continue
        start = bset[s].bp if bset[s].bp >= 0 else int(ws[wa])
        end = bset[s + 1].bp if bset[s + 1].bp >= 0 else int(we[wb - 1])
        cil = start - bp_tol if bset[s].bp >= 0 else int(ws[wa])
        cih = start + bp_tol if bset[s].bp >= 0 else int(we[wa]) - 1
        cel = end - bp_tol if bset[s + 1].bp >= 0 else int(ws[wb - 1])
        ceh = end + bp_tol if bset[s + 1].bp >= 0 else int(we[wb - 1])
        cn = (cfg.ploidy * segcov[s] / segexp[s]
              if segexp[s] > 0 else cfg.ploidy)
        rec = CNV(ref_index, start, end, cil, cih, cel, ceh,
                  cn=cn, mappable=1.0)
        rec.srleft = bset[s].sr
        rec.srright = bset[s + 1].sr
        cnvs.append(rec)


def genotype_cnvs(cfg, gcbound, gc_content, uniq_content, gcbias, tile_fac,
                  reg_win, cov, cov_uniq, cov_map, reflen: int,
                  ref_index: int, cnvs: list) -> None:
    """Per-CNV CN / mappable / uniqfrac / SD (cnv.h:137-202)."""
    cov_curve = np.asarray([gb.coverage for gb in gcbias])
    valid = ((gc_content > gcbound[0]) & (gc_content < gcbound[1])
             & (uniq_content >= uniq_threshold(cfg)))
    for cnv in cnvs:
        if cnv.chr != ref_index:
            continue
        lo = cnv.start
        hi = max(lo, min(cnv.end, reflen))
        # an empty range still overwrites cn/mappable/uniqfrac like the
        # reference's zero-iteration loops (cnv.h:137-169) — stale
        # parsed MP/UNIQ must not survive into the output FILTER
        m = valid[lo:hi]
        idx = np.nonzero(m)[0] + lo
        winlen = len(idx)
        ccov = cov[idx].astype(np.float64)
        evals = (cov_curve[gc_content[idx].astype(np.int64)] if winlen
                 else np.zeros(0))
        if winlen and len(tile_fac):
            evals = evals * tile_fac[idx // reg_win]
        span = cnv.end - cnv.start
        cnv.mappable = winlen / span if span > 0 else 0.0

        ucov = float(cov_uniq[lo:hi].sum())
        tcov = float(cov_map[lo:hi].sum())
        cnv.uniqfrac = ucov / tcov if tcov > 0 else -1.0

        # CN + chunked-SD with the reference's exact sequential sums
        # and boost lazy variance (cnv.h:140-199). covsum is a sum of
        # uint16 values (exact in f64 regardless of order) but expcov
        # and the per-chunk CN pushes are order-sensitive float sums.
        got = native.cnv_gt_core(ccov, evals, cfg.ploidy)
        if got is not None:
            cnv.cn, cnv.sd = got
        else:
            covsum = expcov = 0.0
            for k in range(winlen):
                covsum += ccov[k]
                expcov += evals[k]
            cnv.cn = (cfg.ploidy * covsum / expcov if expcov > 0
                      else cfg.ploidy)
            wsz = winlen // 10
            if wsz > 1:
                n_acc = s_acc = ss_acc = 0.0
                covsum = expcov = 0.0
                wl = 0
                for k in range(winlen):
                    covsum += ccov[k]
                    expcov += evals[k]
                    wl += 1
                    if wl % wsz == 0:
                        c = (cfg.ploidy * covsum / expcov if expcov > 0
                             else float(cfg.ploidy))
                        n_acc += 1.0
                        s_acc += c
                        ss_acc += c * c
                        covsum = expcov = 0.0
                mean = s_acc / n_acc
                var = ss_acc / n_acc - mean * mean
                # std::sqrt of a slightly-negative rounding residue is
                # NaN in the reference path; `NaN < 0.025` is false so
                # NaN passes through — match that, don't raise
                sd = math.sqrt(var) if var >= 0.0 else float("nan")
                cnv.sd = sd if not sd < 0.025 else 0.025
            else:
                cnv.cn = -1
                cnv.sd = 0.025


def merge_adjacent_same_cn(cnvs: list, merge_tol: float) -> list:
    """cnv.h:205-234."""
    if not cnvs:
        return cnvs
    out = [cnvs[0]]
    for cur in cnvs[1:]:
        prev = out[-1]
        same_cn = False
        if prev.cn >= 0 and cur.cn >= 0:
            zl = np.log2(max(prev.cn, 0.03))
            zr = np.log2(max(cur.cn, 0.03))
            same_cn = abs(zl - zr) < merge_tol
        if same_cn and prev.chr == cur.chr:
            w1 = float(prev.end - prev.start)
            w2 = float(cur.end - cur.start)
            wsum = w1 + w2 if w1 + w2 > 0 else 1.0
            prev.cn = (prev.cn * w1 + cur.cn * w2) / wsum
            prev.mappable = (prev.mappable * w1 + cur.mappable * w2) / wsum
            prev.sd = (prev.sd * w1 + cur.sd * w2) / wsum
            prev.ciendlow = cur.ciendlow
            prev.ciendhigh = cur.ciendhigh
            prev.end = cur.end
            prev.srright = cur.srright
        else:
            out.append(cur)
    return out


def parse_vcf_cnv(path: str, header) -> list:
    """Delly CNV BCF/VCF re-genotyping input (cnv.h:463-555)."""
    rdr = VcfReader(path)
    cnvs = []
    # "delly file?" is decided ONCE from the first record's SVMETHOD
    # (cnv.h:491-497 wimethod); later records are not re-checked
    wimethod = 0
    for rec in rdr.records:
        info = rec["info"]
        if not wimethod:
            method = info.get("SVMETHOD", "")
            wimethod = 1 if str(method).startswith("EMBL.DELLY") else 2
        if wimethod != 1:
            continue
        if info.get("SVTYPE") != "CNV":
            continue
        cnv = CNV()
        cnv.chr = header.name2id(rec["chrom"])
        cnv.start = rec["pos"] - 1
        try:
            cnv.qval = int(float(rec["qual"]))
        except (TypeError, ValueError):
            cnv.qval = 0
        if rec["id"] and rec["id"] != ".":
            cnv.id = rec["id"]
        if "END" not in info:
            continue
        cnv.end = int(info["END"])
        if "CIPOS" in info:
            lo, hi = str(info["CIPOS"]).split(",")
            cnv.ciposlow = cnv.start + int(lo)
            cnv.ciposhigh = cnv.start + int(hi)
        else:
            cnv.ciposlow = cnv.start - 50
            cnv.ciposhigh = cnv.start + 50
        if "CIEND" in info:
            lo, hi = str(info["CIEND"]).split(",")
            cnv.ciendlow = cnv.end + int(lo)
            cnv.ciendhigh = cnv.end + int(hi)
        else:
            cnv.ciendlow = cnv.end - 50
            cnv.ciendhigh = cnv.end + 50
        cnv.mappable = float(info.get("MP", 0))
        cnv.srleft = int(info.get("SRL", 0))
        cnv.srright = int(info.get("SRR", 0))
        cnvs.append(cnv)
    return cnvs


CNV_HEADER_LINES = [
    '##ALT=<ID=CNV,Description="copy-number variants">',
    '##FILTER=<ID=LowQual,Description="Poor quality copy-number variant">',
    '##INFO=<ID=CIEND,Number=2,Type=Integer,Description="Confidence interval around END">',
    '##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the copy-number variant">',
    '##INFO=<ID=MP,Number=1,Type=Float,Description="Callable fraction of the CNV span">',
    '##INFO=<ID=UNIQ,Number=1,Type=Float,Description="Uniquely-mappable fraction">',
    '##INFO=<ID=SRL,Number=1,Type=Integer,Description="Split-read support at the left breakpoint">',
    '##INFO=<ID=SRR,Number=1,Type=Integer,Description="Split-read support at the right breakpoint">',
    '##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise copy-number variant">',
    '##INFO=<ID=PRECISE,Number=0,Type=Flag,Description="Precise copy-number variant">',
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
    '##INFO=<ID=SVMETHOD,Number=1,Type=String,Description="Type of approach used to detect CNV">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=CN,Number=1,Type=Integer,Description="Integer copy-number">',
    '##FORMAT=<ID=CNL,Number=.,Type=Float,Description="Log10-scaled copy-number likelihoods">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">',
    '##FORMAT=<ID=FT,Number=1,Type=String,Description="Per-sample genotype filter">',
    '##FORMAT=<ID=RDCN,Number=1,Type=Float,Description="Read-depth based copy-number estimate">',
    '##FORMAT=<ID=RDSD,Number=1,Type=Float,Description="Read-depth standard deviation">',
]

CNV_FORMAT_KEYS = ["GT", "CN", "CNL", "GQ", "FT", "RDCN", "RDSD"]


def cnv_vcf(cfg, header, cnvs: list) -> None:
    """CNV VCF emission (cnv.h:558-742)."""
    writer = VcfWriter(cfg.outfile, header.names, header.lengths,
                       [cfg.sample_name], cfg.genome,
                       header_lines=CNV_HEADER_LINES,
                       format_keys=CNV_FORMAT_KEYS)
    seg_out = open(cfg.segfile, "w") if cfg.segfile else None
    stage("Genotyping")
    cnvid = 0
    for i, cnv in enumerate(cnvs):
        if cnv.chr < 0:
            # contig absent from this BAM (re-genotyping a BCF from a
            # different assembly): negative indexing would silently
            # write the record onto the LAST contig; the reference
            # never emits these (cn stays -1 / UB) — skip
            continue
        if not cfg.genofile and cnv.cn == -1:
            continue
        abs_cn = iround(cnv.cn)  # half away from zero (cnv.h:640)
        if seg_out and cnv.mappable >= cfg.cn_min_callable:
            seg_out.write(f"{header.names[cnv.chr]}\t{cnv.start}\t{cnv.end}"
                          f"\tSEG{i + 1}\t{fmt_float(cnv.cn)}\n")
        if not cfg.genofile and abs_cn == cfg.ploidy:
            continue
        sv_end = min(cnv.end, header.lengths[cnv.chr] - 1)
        if cfg.genofile and cnv.id:
            vid = cnv.id
        else:
            cnvid += 1
            vid = f"CNV{cnvid:08d}"
        info = []
        if cnv.srleft > 0 and cnv.srright > 0:
            info.append(("PRECISE", None))
        else:
            info.append(("IMPRECISE", None))
        info.append(("SVTYPE", "CNV"))
        info.append(("SVMETHOD", SVMETHOD))
        info.append(("END", sv_end))
        info.append(("CIPOS", f"{cnv.ciposlow - cnv.start},"
                              f"{cnv.ciposhigh - cnv.start}"))
        info.append(("CIEND", f"{cnv.ciendlow - cnv.end},"
                              f"{cnv.ciendhigh - cnv.end}"))
        info.append(("MP", fmt_float32(cnv.mappable)))
        info.append(("UNIQ", fmt_float32(cnv.uniqfrac)))
        info.append(("SRL", cnv.srleft))
        info.append(("SRR", cnv.srright))

        gl, gq, varqual, _best = compute_cnls(cnv.cn, cnv.sd, cfg.ploidy)
        qual = cnv.qval if cfg.genofile else varqual
        lowq = qual < 15 or cnv.mappable < cfg.cn_min_callable
        filt = "LowQual" if lowq else "PASS"
        ft = ("LowQual" if gq < 15 or cnv.mappable < cfg.cn_min_callable
              else "PASS")
        fields = {
            "GT": "./.",
            "CN": abs_cn,
            "CNL": ",".join(fmt_float32(g) for g in gl),
            "GQ": gq,
            "FT": ft,
            "RDCN": fmt_float32(cnv.cn),
            "RDSD": fmt_float32(cnv.sd),
        }
        writer.write_record(header.names[cnv.chr], cnv.start + 1, vid, "N",
                            "<CNV>", qual, filt, info, [fields])
    if seg_out:
        seg_out.close()
    writer.close()

"""Somatic / germline SV and CNV filtering (delly filter).

Reference: src/filter.h. Somatic SV: tumor ALT-AF/coverage gates with
zero-contamination controls and an RDRATIO annotation. Germline SV:
AF / RD-ratio / genotype-ratio gates plus GL-based population refinement
(EM allele frequencies, posterior GQ re-genotyping, HWE excess-het
filter) and redundant-site collapse by proximity + dosage R². Germline
CNV: CNV→DEL/DUP reclassification with population SD, CN-shift
correction and biallelic PL recompute. Somatic CNV: tumor-vs-control
Gaussian overlap test. `--tag` soft-filters instead of dropping.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as _np



from delly_tpu_torch.io.vcf import VcfReader
from delly_tpu_torch.ops.likelihood import compute_cnls
from delly_tpu_torch.ops.popgen import (
    dosage_r2, site_stats,
)
from delly_tpu_torch.utils.log import stage


from delly_tpu_torch.utils.stats import iround as _iround
from delly_tpu_torch.utils.stats import seq_sum as _seq_sum

MAX_CN = 10


@dataclass
class FilterConfig:
    """filter.h:51-85, defaults filter.h:1019-1077."""
    vcffile: str = ""
    outfile: str = "-"
    samplefile: str = ""
    filter: str = "somatic"
    minsize: int = 0
    maxsize: int = 500000000
    qualthres: int = 300
    altaf: float = 0.03
    ratiogeno: float = 0.75
    coverage: int = 10
    controlcont: float = 0.0
    pgerm: float = 0.001
    cn_offset: float = 0.2
    rddel: float = 0.8
    rddup: float = 1.2
    genogq: float = 10.0
    rdist: int = 250
    rsize: float = 0.8
    maxsd: float = 0.5
    ploidy: int = 2
    rec_cnv: float = 0.8
    hwe: float = 0.000001
    no_collapse: bool = False
    no_refine: bool = False
    filter_for_pass: bool = False
    soft_filter: bool = False
    rcorr: float = 0.8
    rminshared: int = 20
    epsilon: float = 1e-20
    maxiter: int = 1000
    tumor_set: set = field(default_factory=set)
    control_set: set = field(default_factory=set)

    def __post_init__(self):
        # C floats in the reference (filter.h:65-77); boundary
        # comparisons must see the f32-rounded values
        from delly_tpu_torch.models.config import _f32
        _f32("ratiogeno", "altaf", "controlcont", "genogq", "hwe",
             "rsize", "rcorr", "rddel", "rddup", "maxsd", "rec_cnv",
             "pgerm", "cn_offset")(self)
        if self.filter == "germline":
            self.controlcont = 1.0


def get_median(vals: list) -> float:
    """util.h:744-748 (nth_element at n/2)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[len(s) // 2]


def get_percentile(vals: list, p: float) -> float:
    """util.h:750-756."""
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(int(len(s) * p), len(s) - 1)
    return s[idx]


def _serialize(rec, out) -> None:
    info = ";".join(k if v is True else f"{k}={v}"
                    for k, v in rec["info"].items())
    cols = [rec["chrom"], str(rec["pos"]), rec["id"], rec["ref"],
            rec["alt"], str(rec["qual"]), rec["filter"], info]
    samples = rec.get("samples")
    if samples:
        fmt_keys = list(samples[0].keys())
        cols.append(":".join(fmt_keys))
        for sm in samples:
            cols.append(":".join(str(sm.get(k, ".")) for k in fmt_keys))
    out.append("\t".join(cols))


@lru_cache(maxsize=256)
def _parse_gt(gt: str):
    """Returns (a0, a1) or None for missing. Cohorts carry only a
    handful of distinct GT strings, so the parse is memoized."""
    parts = gt.replace("|", "/").split("/")
    if len(parts) != 2 or "." in parts:
        return None
    try:
        return int(parts[0]), int(parts[1])
    except ValueError:
        return None


def _fmt_int(sm, key):
    v = sm.get(key, ".")
    if type(v) is int:
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


def _fmt_float(sm, key):
    """FORMAT float fetch: the reference reads these through
    bcf_get_format_float, i.e. the FLOAT32 of the text value
    (filter.h:171-172, 246-247) — the f32 parse propagates into the
    CN-shift arithmetic and the recomputed CNLs."""
    try:
        return float(_np.float32(sm.get(key, ".")))
    except ValueError:
        return None


def _qual(rec) -> float:
    try:
        return float(rec["qual"])
    except (TypeError, ValueError):
        return 0.0


@dataclass
class RedRec:
    """filter.h:89-102."""
    rec: dict
    svtype: str
    spos: int
    epos: int
    length: int
    qual: float
    precise: bool
    eligible: bool
    redundant: bool = False
    dos: list = field(default_factory=list)
    ac: int = 0
    ncalled: int = 0


def red_better(a: RedRec, b: RedRec) -> bool:
    """filter.h:105-111."""
    if a.precise != b.precise:
        return a.precise
    if a.ncalled != b.ncalled:
        return a.ncalled > b.ncalled
    if a.ac != b.ac:
        return a.ac > b.ac
    return a.qual > b.qual


def red_proximal(a: RedRec, b: RedRec, rdist: int, rsize: float) -> bool:
    """filter.h:114-126."""
    if a.svtype != b.svtype:
        return False
    if a.svtype == "BND":
        return False
    if abs(a.spos - b.spos) > rdist:
        return False
    if a.svtype != "INS":
        if abs(a.epos - b.epos) > rdist:
            return False
    mn = min(a.length, b.length)
    mx = max(a.length, b.length)
    if mx > 0 and mn / mx < rsize:
        return False
    return True


def red_reciprocal(a: RedRec, b: RedRec, rec_overlap: float) -> bool:
    """filter.h:129-139."""
    if a.svtype != b.svtype:
        return False
    ovl = min(a.epos, b.epos) - max(a.spos, b.spos)
    if ovl <= 0:
        return False
    mx = max(a.epos - a.spos, b.epos - b.spos)
    if mx <= 0:
        return False
    return ovl / mx >= rec_overlap


def _flush_redundancy(win: list, flush_below: int, flush_all: bool,
                      out: list, soft_filter: bool) -> None:
    """filter.h:141-160."""
    keep = []
    for rr in win:
        if not flush_all and rr.spos >= flush_below:
            keep.append(rr)
            continue
        drop = False
        if rr.eligible and rr.redundant:
            if soft_filter:
                rr.rec["filter"] = "RedundantSV"
            else:
                drop = True
        if not drop:
            _serialize(rr.rec, out)
    win[:] = keep


def _population_annotations(cfg, rec, gl_vector):
    """Shared AFmle/ACmle/GFmle/FIC/RSQ/HWEpval annotation block.
    Returns (fic, hwe_pval, mle_gt_freq)."""
    hwe_af, mle, fic, rsq, pval = site_stats(gl_vector, cfg.epsilon,
                                             cfg.maxiter)
    # the reference stores these as BCF float32 (filter.h:421-441) —
    # render through np.float32 so %g digits match
    info = rec["info"]
    info["AFmle"] = f"{_np.float32(hwe_af[1]):g}"
    info["ACmle"] = int(_iround(hwe_af[1] * 2.0 * len(gl_vector)))
    info["GFmle"] = ",".join(f"{_np.float32(x):g}" for x in mle)
    info["FIC"] = f"{_np.float32(fic):g}"
    info["RSQ"] = f"{_np.float32(rsq):g}"
    info["HWEpval"] = f"{_np.float32(pval):g}"
    return fic, pval, mle


def filter_germline_cnv(cfg, rec):
    """CNV -> DEL/DUP reclassification + population refinement
    (filter.h:228-493). Returns (failgerm, dos, ac, ncalled, svtype)."""
    samples = rec.get("samples", [])
    nsmpl = len(samples)
    out_svtype = "CNV"
    dos = [-1] * nsmpl
    cnvac = 0
    cnvncalled = 0
    rdcn = [_fmt_float(sm, "RDCN") for sm in samples]
    # ok = the RDCN FORMAT exists for the record (filter.h:252); a
    # single sample's missing value ('.') only invalidates that sample
    # (validSmpl[i]=false, filter.h:276) — it must not drop the site
    ok = nsmpl > 0 and any("RDCN" in sm for sm in samples)

    refined = False
    keep = False
    ncar = 0
    fic_store = 0.0
    hwe_store = 1.0
    cnsd_store = 0.0

    if ok:
        valid = [v is not None and math.isfinite(v) and v != -1
                 for v in rdcn]
        confident = [valid[i] and samples[i].get("FT") == "PASS"
                     for i in range(nsmpl)]
        shift_vals = [_iround(rdcn[i]) - rdcn[i]
                      for i in range(nsmpl) if confident[i]]
        nconf = len(shift_vals)
        cnshift = _seq_sum(shift_vals) / nconf if nconf else 0.0
        cncount = [0] * MAX_CN
        hdel = hdup = hbeyond = 0
        for i in range(nsmpl):
            if not valid[i]:
                continue
            # float += double stores back into the f32 array
            # (filter.h:294)
            rdcn[i] = float(_np.float32(rdcn[i] + cnshift))
            if not confident[i]:
                continue
            r = int(_iround(rdcn[i]))
            if 0 <= r < MAX_CN:
                cncount[r] += 1
            if r in (0, 1):
                hdel += 1
            elif r in (3, 4):
                hdup += 1
            elif r >= 5:
                hbeyond += 1
        ncar = hdel + hdup + hbeyond
        cnmain = 0
        for k in range(1, MAX_CN):
            if cncount[k] > cncount[cnmain]:
                cnmain = k
        cls = "CNV"
        if nconf < 50 or ncar == 0:
            cls = "DROP"
        elif hdel >= hdup and (hdup + hbeyond) <= 0.05 * ncar:
            cls = "DEL"
        elif hdup > hdel and (hdel + hbeyond) <= 0.05 * ncar:
            cls = "DUP"

        if cls != "DROP":
            keep = True
            out_svtype = cls
            biallelic = cls in ("DEL", "DUP")
            s_rr, s_ra, s_aa = 2, 1, 0
            if cls == "DUP":
                s_ra, s_aa = 3, 4

            main_vals = [rdcn[i] for i in range(nsmpl)
                         if confident[i] and int(_iround(rdcn[i])) == cnmain]
            if main_vals:
                s_mean = _seq_sum(main_vals) / len(main_vals)
                sd = math.sqrt(
                    _seq_sum((v - s_mean) ** 2 for v in main_vals)
                    / len(main_vals))
            else:
                sd = 0.025
            if sd < 0.025:
                sd = 0.025
            cnsd_store = sd

            gl_vector = []
            for i, sm in enumerate(samples):
                if not valid[i]:
                    sm["GT"] = "./."
                    if biallelic:
                        sm["PL"] = ".,.,."
                    sm["CN"] = "."
                    sm["GQ"] = 0
                    continue
                gl, gq, _vq, _best = compute_cnls(rdcn[i], sd, cfg.ploidy)
                sm["CN"] = int(_iround(rdcn[i]))
                # BCF float32 FORMAT fields (filter.h:466-471)
                sm["CNL"] = ",".join(f"{_np.float32(g):g}" for g in gl)
                sm["GQ"] = gq
                sm["RDCN"] = f"{_np.float32(rdcn[i]):g}"
                if not biallelic:
                    # PL is only written for biallelic reclassifications
                    # (filter.h:467); multi-allelic CNVs keep whatever
                    # PL the input carried
                    sm["GT"] = "./."
                    continue
                gl_rr = gl[s_rr]
                gl_ra = gl[s_ra]
                gl_aa = gl[s_aa]
                best_gt = 0
                gl_best = gl_rr
                if gl_ra > gl_best:
                    best_gt, gl_best = 1, gl_ra
                if gl_aa > gl_best:
                    best_gt, gl_best = 2, gl_aa
                pls = [max(0, int(_iround(-10.0 * (g - gl_best))))
                       for g in (gl_rr, gl_ra, gl_aa)]
                sm["PL"] = ",".join(str(p) for p in pls)
                sm["GT"] = ("0/0", "0/1", "1/1")[best_gt]
                if confident[i]:
                    gl_vector.append([10.0 ** gl_rr, 10.0 ** gl_ra,
                                      10.0 ** gl_aa])
                    dos[i] = best_gt
                    cnvac += best_gt
                    cnvncalled += 1

            if gl_vector:
                refined = True
                fic_store, hwe_store, _ = _population_annotations(
                    cfg, rec, gl_vector)

            info = rec["info"]
            info["CNSHIFT"] = f"{_np.float32(cnshift):g}"
            info["CNSD"] = f"{_np.float32(sd):g}"
            info["SUBTYPE"] = "CNV"
            info["SVTYPE"] = cls
            # the reference rewrites the alleles to N,<CLS>
            # (filter.h:455-456)
            rec["ref"] = "N"
            rec["alt"] = f"<{cls}>"
            for i, sm in enumerate(samples):
                gq = sm.get("GQ")
                gq_low = isinstance(gq, int) and gq < 15
                sm["FT"] = ("LowQual" if (not confident[i] or gq_low)
                            else "PASS")

    failgerm = not keep
    if cnsd_store > cfg.maxsd:
        failgerm = True
    if (refined and ncar >= 10 and cfg.hwe > 0 and fic_store < 0
            and hwe_store < cfg.hwe):
        failgerm = True
    if keep and not failgerm:
        rec["filter"] = "PASS"
    return failgerm, dos, cnvac, cnvncalled, out_svtype


def filter_somatic_cnv(cfg, rec) -> bool:
    """Tumor-vs-control Gaussian overlap test (filter.h:163-225).
    Returns True on fail."""
    samples = rec.get("samples", [])
    names = rec.get("_sample_names", [])
    control = []
    tumor = []
    for name, sm in zip(names, samples):
        cn = _fmt_float(sm, "RDCN")
        sd = _fmt_float(sm, "RDSD")
        if cn is None or not math.isfinite(cn) or cn == -1:
            return True
        # the reference requires the RDSD FORMAT (filter.h:174) —
        # substituting a tiny SD would make the Gaussian overlap test
        # maximally confident on data it cannot assess
        if sd is None:
            return True
        if name in cfg.control_set:
            control.append((cn, sd))
        elif name in cfg.tumor_set:
            tumor.append((cn, sd))
    if not tumor or not control:
        return True

    def norm_pdf(x, mean, sd):
        sd = max(0.025, sd)
        return math.exp(-0.5 * ((x - mean) / sd) ** 2) / (
            sd * math.sqrt(2 * math.pi))

    best_cn_offset = 0.0
    somatic = False
    lowest_p = 1.0
    for tcn, tsd in tumor:
        germ = False
        highest_prob = 0.0
        tcn_offset = -1.0
        for ccn, csd in control:
            prob = max(norm_pdf(tcn, ccn, csd), norm_pdf(ccn, tcn, tsd))
            if prob > cfg.pgerm:
                germ = True
            elif prob > highest_prob:
                highest_prob = prob
            cndiff = abs(tcn - ccn)
            if cndiff < cfg.cn_offset:
                germ = True
            elif tcn_offset == -1 or cndiff < tcn_offset:
                tcn_offset = cndiff
        if not germ:
            somatic = True
            if highest_prob < lowest_p and tcn_offset > best_cn_offset:
                lowest_p = highest_prob
                best_cn_offset = tcn_offset
    if somatic:
        info = rec["info"]
        info["SOMATIC"] = True
        # f32 renderings like the reference's float casts (filter.h:215-219)
        info["PGERM"] = f"{_np.float32(lowest_p):g}"
        info["CNDIFF"] = f"{_np.float32(best_cn_offset):g}"
        return False
    return True


def filter_run(cfg: FilterConfig) -> int:
    """filter.h:495-1012."""
    rdr = VcfReader(cfg.vcffile)
    sample_names = rdr.samples
    germline = cfg.filter == "germline"
    collapse = germline and not cfg.no_collapse

    header = list(rdr.header_lines)
    extra = []
    if cfg.filter == "somatic":
        extra = [
            '##INFO=<ID=RDRATIO,Number=1,Type=Float,Description="Read-depth ratio of tumor vs. normal.">',
            '##INFO=<ID=SOMATIC,Number=0,Type=Flag,Description="Somatic structural variant.">',
            '##INFO=<ID=PGERM,Number=1,Type=Float,Description="Probability of being germline.">',
            '##INFO=<ID=CNDIFF,Number=1,Type=Float,Description="Absolute tumor-control copy-number difference.">',
        ]
        if cfg.soft_filter:
            extra += [
                '##FILTER=<ID=FailDellyFilter,Description="Failed delly filter.">',
                '##FILTER=<ID=FailSomatic,Description="Failed somatic filter (likely germline variant).">',
            ]
    else:
        extra = [
            '##INFO=<ID=RDRATIO,Number=1,Type=Float,Description="Read-depth ratio of SV carrier vs. non-carrier.">',
            '##INFO=<ID=AFmle,Number=1,Type=Float,Description="AF estimated from genotype likelihoods.">',
            '##INFO=<ID=ACmle,Number=1,Type=Integer,Description="Allele count estimated from genotype likelihoods.">',
            '##INFO=<ID=GFmle,Number=G,Type=Float,Description="GT frequencies estimated from GLs.">',
            '##INFO=<ID=FIC,Number=1,Type=Float,Description="Inbreeding coefficient.">',
            '##INFO=<ID=RSQ,Number=1,Type=Float,Description="Imputation quality R^2.">',
            '##INFO=<ID=HWEpval,Number=1,Type=Float,Description="HWE likelihood-ratio test p-value.">',
            '##INFO=<ID=CNSHIFT,Number=1,Type=Float,Description="Estimated CN shift.">',
            '##INFO=<ID=CNSD,Number=1,Type=Float,Description="CN standard deviation.">',
        ]
        # reclassified CNVs emit SUBTYPE/PL/<DEL>/<DUP> (filter.h:536-540)
        hdr_text = "\n".join(header)
        if "##INFO=<ID=SUBTYPE" not in hdr_text:
            extra.append('##INFO=<ID=SUBTYPE,Number=1,Type=String,'
                         'Description="Structural variant subtype.">')
        if "##FORMAT=<ID=PL" not in hdr_text:
            extra.append('##FORMAT=<ID=PL,Number=G,Type=Integer,'
                         'Description="Phred-scaled genotype likelihoods'
                         ' for RR,RA,AA genotypes.">')
        if "##ALT=<ID=DEL" not in hdr_text:
            extra.append('##ALT=<ID=DEL,Description="Deletion">')
        if "##ALT=<ID=DUP" not in hdr_text:
            extra.append('##ALT=<ID=DUP,Description="Duplication">')
        if cfg.soft_filter:
            extra += [
                '##FILTER=<ID=RedundantSV,Description="Redundant SV site.">',
                '##FILTER=<ID=FailDellyFilter,Description="Failed delly filter.">',
                '##FILTER=<ID=FailGermline,Description="Failed germline filter.">',
            ]
    header += extra

    out = []
    red_win = []
    red_chrom = None
    stage("Filtering VCF/BCF file")

    for rec in rdr.records:
        rec["_sample_names"] = sample_names
        info = rec["info"]
        svt = str(info.get("SVTYPE", ""))
        cnv_rec = germline and svt == "CNV"
        if collapse:
            if rec["chrom"] != red_chrom:
                _flush_redundancy(red_win, 0, True, out, cfg.soft_filter)
                red_chrom = rec["chrom"]
            elif not cnv_rec:
                _flush_redundancy(red_win, rec["pos"] - 1 - cfg.rdist,
                                  False, out, cfg.soft_filter)

        pass_ok = True
        if cfg.filter_for_pass:
            pass_ok = rec["filter"] == "PASS"
        try:
            svend = int(str(info.get("END")))
        except (TypeError, ValueError):
            svend = None
        svlen = (svend - (rec["pos"] - 1)) if svend is not None else 1

        if germline and svt == "CNV":
            if pass_ok and cfg.minsize <= svlen <= cfg.maxsize:
                precise = "PRECISE" in info
                failgerm, dos, cac, ncalled, cnsvt = filter_germline_cnv(
                    cfg, rec)
                if not failgerm:
                    if collapse:
                        rr = RedRec(rec, cnsvt, rec["pos"] - 1,
                                    svend if svend is not None
                                    else rec["pos"] - 1, abs(svlen),
                                    _qual(rec), precise, True,
                                    dos=dos, ac=cac, ncalled=ncalled)
                        for wit in red_win:
                            if not wit.eligible or wit.redundant:
                                continue
                            if red_reciprocal(rr, wit, cfg.rec_cnv):
                                r2 = dosage_r2(rr.dos, wit.dos,
                                               cfg.rminshared)
                                if r2 >= cfg.rcorr:
                                    if red_better(rr, wit):
                                        wit.redundant = True
                                    else:
                                        rr.redundant = True
                                        break
                        red_win.append(rr)
                    else:
                        _serialize(rec, out)
                elif cfg.soft_filter:
                    rec["filter"] = "FailGermline"
                    if collapse:
                        red_win.append(RedRec(
                            rec, cnsvt, rec["pos"] - 1,
                            svend if svend is not None else rec["pos"] - 1,
                            0, _qual(rec), precise, False))
                    else:
                        _serialize(rec, out)
            elif cfg.soft_filter:
                rec["filter"] = "FailDellyFilter"
                if collapse:
                    red_win.append(RedRec(
                        rec, "CNV", rec["pos"] - 1,
                        svend if svend is not None else rec["pos"] - 1,
                        0, _qual(rec), False, False))
                else:
                    _serialize(rec, out)
            continue

        if svt == "CNV":
            if pass_ok and cfg.minsize <= svlen <= cfg.maxsize:
                failsom = filter_somatic_cnv(cfg, rec)
                if not failsom:
                    _serialize(rec, out)
                elif cfg.soft_filter:
                    rec["filter"] = "FailSomatic"
                    _serialize(rec, out)
            elif cfg.soft_filter:
                rec["filter"] = "FailDellyFilter"
                _serialize(rec, out)
            continue

        # SVs (filter.h:703-973)
        inslen = 0
        try:
            inslen = int(str(info.get("INSLEN", 0)))
        except ValueError:
            pass
        size_ok = (svt == "BND"
                   or (svt == "INS"
                       and cfg.minsize <= inslen <= cfg.maxsize)
                   or (svt not in ("BND", "INS")
                       and cfg.minsize <= svlen <= cfg.maxsize))
        if _qual(rec) >= cfg.qualthres and pass_ok and size_ok:
            precise = "PRECISE" in info
            samples = rec.get("samples", [])
            nsmpl = len(samples)
            refined = False
            hwe_store = 1.0
            fic_store = 0.0
            # refinement requires a biallelic record (filter.h:718
            # rec->n_allele == 2) with PL present
            biallelic = (rec["alt"] not in ("", ".")
                         and "," not in rec["alt"])
            if (germline and not cfg.no_refine and biallelic
                    and any("PL" in sm for sm in samples)):
                gl_vector = []
                gl_sample_idx = []
                for i, sm in enumerate(samples):
                    gt = _parse_gt(sm.get("GT", "."))
                    if gt is None:
                        continue
                    pl = sm.get("PL", ".")
                    try:
                        plv = [int(x) for x in pl.split(",")]
                    except ValueError:
                        continue
                    if len(plv) < 3:
                        continue
                    gl_vector.append([10.0 ** (-p / 10.0)
                                      for p in plv[:3]])
                    gl_sample_idx.append(i)
                if gl_vector:
                    refined = True
                    fic_store, hwe_store, mle = _population_annotations(
                        cfg, rec, gl_vector)
                    # Posterior GQ re-genotyping (filter.h:761-787)
                    for gi, i in enumerate(gl_sample_idx):
                        sm = samples[i]
                        plv = [int(x)
                               for x in sm.get("PL", ".").split(",")][:3]
                        pp = [mle[k] * 10.0 ** (-plv[k] / 10.0)
                              for k in range(3)]
                        best_idx = plv.index(min(plv))
                        sum_pp = _seq_sum(pp)
                        sample_gq = 0.0
                        if sum_pp > 0:
                            frac = 1.0 - pp[best_idx] / sum_pp
                            sample_gq = (-10.0 * math.log10(frac)
                                         if frac > 0 else 99.0)
                        sample_gq = min(max(sample_gq, 0.0), 99.0)
                        if sample_gq < cfg.genogq:
                            sm["GT"] = "./."
                        sm["GQ"] = int(sample_gq + 0.5)

            rc_control = []
            rc_tumor = []
            rc_alt = []
            r_ref_var = []
            r_alt_var = []
            n_count = 0
            t_count = 0
            controlpass = 0
            tumorpass = 0
            ac = [0, 0]
            for name, sm in zip(sample_names, samples):
                gt = _parse_gt(sm.get("GT", "."))
                if gt is None:
                    continue
                a0, a1 = gt
                gt_type = a0 + a1
                ac[1 if a0 > 0 else 0] += 1
                ac[1 if a1 > 0 else 0] += 1
                rc = _fmt_int(sm, "RC") or 0
                rcl = _fmt_int(sm, "RCL")
                rcr = _fmt_int(sm, "RCR")
                dr = _fmt_int(sm, "DR") or 0
                dv = _fmt_int(sm, "DV") or 0
                rrv = _fmt_int(sm, "RR") or 0
                rvv = _fmt_int(sm, "RV") or 0

                def rvar():
                    # float32 division like the reference's
                    # (float)dv/(float)(dr+dv); zero coverage is
                    # 0/0 = NaN (filter.h:837-840): every comparison
                    # against it is false, so an unassessable control
                    # can never count toward controlpass
                    if not precise:
                        tot = dr + dv
                        return (float(_np.float32(dv) / _np.float32(tot))
                                if tot else float("nan"))
                    tot = rrv + rvv
                    return (float(_np.float32(rvv) / _np.float32(tot))
                            if tot else float("nan"))

                def rc_norm():
                    if rcl is not None and rcr is not None \
                            and rcl + rcr != 0:
                        return float(_np.float32(rc)
                                     / _np.float32(rcl + rcr))
                    return float(rc)

                if germline or name in cfg.control_set:
                    n_count += 1
                    if gt_type == 0:
                        rc_control.append(rc_norm())
                        rv = rvar()
                        r_ref_var.append(rv)
                        if rv <= cfg.controlcont:
                            controlpass += 1
                    elif germline and gt_type >= 1:
                        rc_alt.append(rc_norm())
                        r_alt_var.append(rvar())
                elif not germline and name in cfg.tumor_set:
                    t_count += 1
                    rc_tumor.append(rc_norm())
                    if not precise:
                        tot = dr + dv
                        if (tot and float(_np.float32(dv)
                                          / _np.float32(tot)) >= cfg.altaf
                                and tot >= cfg.coverage):
                            tumorpass += 1
                    else:
                        tot = rrv + rvv
                        if (tot and float(_np.float32(rvv)
                                          / _np.float32(tot)) >= cfg.altaf
                                and tot >= cfg.coverage):
                            tumorpass += 1

            if cfg.filter == "somatic":
                denom = len(cfg.control_set) + len(cfg.tumor_set)
                genotype_ratio = (float(_np.float32(n_count + t_count)
                                        / _np.float32(denom))
                                  if denom else 0.0)
                if (controlpass and tumorpass and controlpass == n_count
                        and genotype_ratio >= cfg.ratiogeno):
                    rccontrolmed = get_median(rc_control)
                    rctumormed = get_median(rc_tumor)
                    rd_ratio = (float(_np.float32(rctumormed)
                                      / _np.float32(rccontrolmed))
                                if rccontrolmed else 1.0)
                    info["RDRATIO"] = f"{_np.float32(rd_ratio):g}"
                    info["SOMATIC"] = True
                    _serialize(rec, out)
                elif cfg.soft_filter:
                    rec["filter"] = "FailSomatic"
                    _serialize(rec, out)
            else:
                genotype_ratio = (float(_np.float32(n_count + t_count)
                                        / _np.float32(nsmpl))
                                  if nsmpl else 0.0)
                rrefvarperc = (get_percentile(r_ref_var, 0.9)
                               if r_ref_var else 0.0)
                raltvarmed = get_median(r_alt_var) if r_alt_var else 0.0
                rccontrolmed = (get_median(rc_control)
                                if rc_control else 0.0)
                rcaltmed = get_median(rc_alt) if rc_alt else 0.0
                rd_ratio = (float(_np.float32(rcaltmed)
                                  / _np.float32(rccontrolmed))
                            if rccontrolmed else 1.0)
                af = (float(_np.float32(ac[1])
                            / _np.float32(ac[0] + ac[1]))
                      if (ac[0] + ac[1]) else 0.0)

                failgerm = not (af > 0 and raltvarmed >= cfg.altaf
                                and genotype_ratio >= cfg.ratiogeno)
                if svt == "DEL" and rd_ratio > cfg.rddel:
                    failgerm = True
                if svt == "DUP" and rd_ratio < cfg.rddup:
                    failgerm = True
                if svt not in ("DEL", "DUP") and rrefvarperc > 0:
                    failgerm = True
                if (refined and cfg.hwe > 0 and fic_store < 0
                        and hwe_store < cfg.hwe):
                    failgerm = True
                if not failgerm:
                    info["RDRATIO"] = f"{_np.float32(rd_ratio):g}"
                    if collapse:
                        rr = RedRec(rec, svt, rec["pos"] - 1,
                                    svend if svend is not None
                                    else rec["pos"] - 1,
                                    inslen if svt == "INS"
                                    else abs(svlen),
                                    _qual(rec), precise, True)
                        rr.dos = [-1] * nsmpl
                        for i, sm in enumerate(samples):
                            gt = _parse_gt(sm.get("GT", "."))
                            if gt is not None:
                                d = ((1 if gt[0] > 0 else 0)
                                     + (1 if gt[1] > 0 else 0))
                                rr.dos[i] = d
                                rr.ncalled += 1
                                rr.ac += d
                        for wit in red_win:
                            if not wit.eligible or wit.redundant:
                                continue
                            if red_proximal(rr, wit, cfg.rdist,
                                            cfg.rsize):
                                r2 = dosage_r2(rr.dos, wit.dos,
                                               cfg.rminshared)
                                if r2 >= cfg.rcorr:
                                    if red_better(rr, wit):
                                        wit.redundant = True
                                    else:
                                        rr.redundant = True
                                        break
                        red_win.append(rr)
                    else:
                        _serialize(rec, out)
                elif cfg.soft_filter:
                    rec["filter"] = "FailGermline"
                    if collapse:
                        red_win.append(RedRec(
                            rec, svt, rec["pos"] - 1,
                            svend if svend is not None
                            else rec["pos"] - 1, 0, _qual(rec), precise,
                            False))
                    else:
                        _serialize(rec, out)
        elif cfg.soft_filter:
            rec["filter"] = "FailDellyFilter"
            if collapse:
                red_win.append(RedRec(
                    rec, svt, rec["pos"] - 1,
                    svend if svend is not None else rec["pos"] - 1, 0,
                    _qual(rec), False, False))
            else:
                _serialize(rec, out)

    if collapse:
        _flush_redundancy(red_win, 0, True, out, cfg.soft_filter)

    from delly_tpu_torch.models.merge import _write_vcf_text
    _write_vcf_text(cfg.outfile, header, rdr.column_header, out)
    stage("Done.")
    return 0


def parse_sample_file(path: str):
    """tumor/control sample sheet (filter.h:1093-1138).
    Returns (tumor_set, control_set)."""
    tumor = set()
    control = set()
    with open(path) as fh:
        for line in fh:
            toks = line.replace(",", " ").replace("\t", " ").split()
            if len(toks) >= 2:
                sample, typ = toks[0], toks[1]
                if typ == "control":
                    control.add(sample)
                elif typ == "tumor":
                    tumor.add(sample)
    return tumor, control

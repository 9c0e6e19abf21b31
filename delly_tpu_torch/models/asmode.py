"""Assembly-based SV calling (delly asm).

Reference: src/asmode.h. Haplotype-resolved (diploid) or squashed
assembly alignments: every qualifying CIGAR indel or clip pair is an SV
candidate (min support 1, no clique clustering); the consensus is the
assembly subsequence around the breakpoint; small indels get direct
left-aligned alleles with homology; candidates are merged across
samples with the merge engine and written with haplotype-aware phased
genotypes (hap bits -> 0|1 GTs).
"""

from __future__ import annotations

import copy
import os
import tempfile
from dataclasses import dataclass, field

from delly_tpu_torch.io.bam import (
    CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS, CMATCH, CREF_SKIP, CSOFT_CLIP,
    FDUP, FQCFAIL, FREVERSE, FSECONDARY, FSUPPLEMENTARY, FUNMAP, BamFile,
)
from delly_tpu_torch.io.fasta import FastaFile
from delly_tpu_torch.models.assemble import SeqSlice
from delly_tpu_torch.models.genotype_sr import (
    JunctionCount, ReadCount, SpanningCount, _add_alleles,
)
from delly_tpu_torch.models.junctions import _insert_junction, fetch_svs
from delly_tpu_torch.models.merge import (
    MergeConfig, MergeSV, cluster_and_select, merge_bcfs,
)
from delly_tpu_torch.models.refine import align_consensus
from delly_tpu_torch.models.svanno import annotate_sv
from delly_tpu_torch.models.vcf_out import vcf_output
from delly_tpu_torch.utils.hashing import hash_combine, hash_lr
from delly_tpu_torch.utils.tags import (
    SRBamRecord, SVT_TRANS, StructuralVariantRecord, is_translocation,
)
from delly_tpu_torch.utils.log import stage


@dataclass
class AsmConfig:
    """asmode.h:39-63, defaults asmode.h:702-737."""
    genome: str = ""
    files: list = field(default_factory=list)
    outfile: str = "-"
    svtset: set = field(default_factory=set)
    mode: str = "squashed"
    min_map_qual: int = 10
    min_clip: int = 25
    min_ref_sep: int = 30
    max_read_sep: int = 100
    min_cons_window: int = 1000
    min_flank_size: int = 100
    flank_quality: float = 0.9
    indelsize: int = 10000
    min_clique_size: int = 2
    graph_pruning: int = 1000
    mei_min_frac: float = 0.8
    tr_min_frac: float = 0.85
    diploid: bool = False
    nsamples: int = 0
    nchr: int = 0
    sample_names: list = field(default_factory=list)
    file_sample: list = field(default_factory=list)
    file_hap: list = field(default_factory=list)
    vcffile: str = "x"  # suppress the min-carrier gate in vcf_output
    dumpfile: str = ""

    def __post_init__(self):
        self.diploid = self.mode == "diploid"
        from delly_tpu_torch.models.config import _f32
        _f32("flank_quality", "mei_min_frac", "tr_min_frac")(self)


HAP_SUFFIXES = [".hap1", ".hap2", ".hapA", ".hapB", ".h1", ".h2", ".mat",
                ".pat", ".maternal", ".paternal", ".1", ".2"]


def strip_haplotype_suffix(s: str) -> str:
    """asmode.h:66-76."""
    for suf in HAP_SUFFIXES:
        if len(s) > len(suf) and s.endswith(suf):
            return s[:-len(suf)]
    return s


def common_sample_name(a: str, b: str) -> str:
    """asmode.h:78-86."""
    k = 0
    n = min(len(a), len(b))
    while k < n and a[k] == b[k]:
        k += 1
    pre = a[:k]
    while pre and pre[-1] in "._-":
        pre = pre[:-1]
    return pre if pre else strip_haplotype_suffix(a)


def _uc(ch: str) -> str:
    return ch.upper()


def find_asm_junctions(cfg, bams, read_bp, read_sample, read_hap, sr_br):
    """Direct CIGAR indel/clip candidates (asmode.h:89-189)."""
    do_del = not cfg.svtset or 2 in cfg.svtset
    do_ins = not cfg.svtset or 4 in cfg.svtset
    header = bams[0].header
    stage("Split-read scanning")
    for ref_index in range(header.n_targets):
        for file_c, bam in enumerate(bams):
            for rec in bam.records(tid=ref_index):
                if rec.flag & (FQCFAIL | FDUP | FUNMAP):
                    continue
                if rec.mapq < cfg.min_map_qual or rec.tid < 0:
                    continue
                seed = hash_combine(hash_lr(rec.qname),
                                    cfg.file_sample[file_c])
                read_sample[seed] = cfg.file_sample[file_c]
                read_hap[seed] = cfg.file_hap[file_c]
                rp = rec.pos
                sp = 0
                read_start = rec.pos
                if rec.flag & (FSECONDARY | FSUPPLEMENTARY):
                    read_start = -1
                seqlen = rec.read_length()
                rev = bool(rec.flag & FREVERSE)
                for op, ol in zip(rec.cigar_ops, rec.cigar_lens):
                    ol = int(ol)
                    if op in (CMATCH, CEQUAL, CDIFF):
                        sp += ol
                        rp += ol
                    elif op == CDEL:
                        if do_del and ol > cfg.min_ref_sep and sp <= seqlen:
                            ss = (seqlen - sp) if rev else sp
                            sr_br[2].append(SRBamRecord(
                                rec.tid, rp, rec.tid, rp + ol, read_start,
                                ss, rec.mapq, 0, seed))
                        rp += ol
                    elif op == CINS:
                        if do_ins and ol > cfg.min_ref_sep \
                                and sp + ol <= seqlen:
                            ss = max(0, (seqlen - sp - ol) if rev else sp)
                            sr_br[4].append(SRBamRecord(
                                rec.tid, rp, rec.tid, rp + 1, read_start,
                                ss, rec.mapq, ol, seed))
                        sp += ol
                    elif op == CREF_SKIP:
                        rp += ol
                    elif op in (CSOFT_CLIP, CHARD_CLIP):
                        finalsp = sp
                        scleft = False
                        if sp == 0:
                            finalsp += ol
                            scleft = True
                        sp += ol
                        if ol > cfg.min_clip:
                            _insert_junction(read_bp, seed, rec, rp,
                                             finalsp, scleft)
    for jv in read_bp.values():
        jv.sort(key=lambda j: j.sort_key())


def find_asm_structural_variants(cfg, bams, svs, sr_store, sv_sample,
                                 sv_hap):
    """asmode.h:204-236: every split is its own SV candidate."""
    nsvt = 2 * SVT_TRANS
    sr_br = [[] for _ in range(nsvt)]
    read_sample = {}
    read_hap = {}
    read_bp = {}
    find_asm_junctions(cfg, bams, read_bp, read_sample, read_hap, sr_br)
    fetch_svs(read_bp, sr_br, cfg.svtset, cfg.max_read_sep, cfg.min_ref_sep)

    ci = 10
    for svt in range(nsvt):
        if not sr_br[svt]:
            continue
        sr_br[svt].sort(key=lambda r: r.sort_key())
        for r in sr_br[svt]:
            svid = len(svs)
            r.svid = svid
            sv = StructuralVariantRecord(
                chr=r.chr, svStart=r.pos, chr2=r.chr2, svEnd=r.pos2,
                ciposlow=-ci, ciposhigh=ci, ciendlow=-ci, ciendhigh=ci,
                srSupport=1, srMapQuality=r.qual, mapq=r.qual,
                insLen=r.inslen, svt=svt, id=svid)
            svs.append(sv)
            sv_sample.append(read_sample.get(r.id, -1))
            sv_hap.append(read_hap.get(r.id, -1))
            sr_store.setdefault(r.id, []).append(
                SeqSlice(svid, r.sstart, r.inslen, r.qual))


def direct_indel_allele(cfg, seq: str, seqlen: int, sv) -> bool:
    """Left-aligned exact indel alleles with homology
    (asmode.h:239-303)."""
    bp = sv.svStart
    if bp < 2 or bp >= seqlen:
        return False
    if sv.svt == 2:
        dellen = sv.svEnd - sv.svStart
        if dellen <= 0 or bp + dellen > seqlen:
            return False
        hom_left = 0
        while bp > 1 and _uc(seq[bp - 1]) == _uc(seq[bp + dellen - 1]):
            bp -= 1
            hom_left += 1
        hom_right = 0
        while (bp + dellen + hom_right < seqlen
               and _uc(seq[bp + hom_right])
               == _uc(seq[bp + dellen + hom_right])):
            hom_right += 1
        sv.svStart = bp
        sv.svEnd = bp + dellen
        if dellen <= cfg.indelsize:
            ref_vcf = "".join(_uc(seq[bp - 1 + k])
                              for k in range(dellen + 1))
            alt_vcf = _uc(seq[bp - 1])
            sv.alleles = f"{ref_vcf},{alt_vcf}"
        sv.homLen = max(0, hom_left + hom_right - 1)
        wig = max(hom_left, hom_right)
        sv.ciposlow = -wig
        sv.ciposhigh = wig
        sv.ciendlow = -wig
        sv.ciendhigh = wig
        sv.precise = True
        sv.srAlignQuality = 1.0
        return True
    if sv.svt == 4:
        inslen = sv.insLen
        cbp = sv.consBp
        if inslen <= 0 or cbp < 0 or cbp + inslen > len(sv.consensus):
            return False
        ins = sv.consensus[cbp:cbp + inslen]
        hom_left = 0
        while bp > 1 and _uc(seq[bp - 1]) == ins[-1]:
            ins = ins[-1] + ins[:-1]
            bp -= 1
            hom_left += 1
        sv.svStart = bp
        sv.svEnd = bp
        alt_vcf = _uc(seq[bp - 1]) + ins
        ref_vcf = _uc(seq[bp - 1])
        sv.alleles = f"{ref_vcf},{alt_vcf}"
        sv.homLen = hom_left
        sv.ciposlow = -hom_left
        sv.ciposhigh = hom_left
        sv.ciendlow = -hom_left
        sv.ciendhigh = hom_left
        sv.precise = True
        sv.srAlignQuality = 1.0
        return True
    return False


def set_asm_consensus(cfg, bams, fasta, svs, sr_store):
    """Assembly subsequence consensus + refinement (asmode.h:306-461)."""
    header = bams[0].header
    stage("Parse assembly alleles")
    for ref_index in range(header.n_targets):
        for file_c, bam in enumerate(bams):
            for rec in bam.records(tid=ref_index):
                if rec.flag & (FQCFAIL | FDUP | FUNMAP | FSECONDARY
                               | FSUPPLEMENTARY):
                    continue
                seed = hash_combine(hash_lr(rec.qname),
                                    cfg.file_sample[file_c])
                slices = sr_store.get(seed)
                if slices is None:
                    continue
                sequence = rec.seq
                readlen = len(sequence)
                for seqsl in slices:
                    sv = svs[seqsl.svid]
                    window = cfg.min_cons_window
                    window += max(sv.ciposhigh - sv.ciposlow,
                                  sv.ciendhigh - sv.ciendlow)
                    if rec.flag & FREVERSE:
                        s_pos = (readlen - seqsl.sstart) - window \
                            - seqsl.inslen
                        e_pos = (readlen - seqsl.sstart) + window
                    else:
                        s_pos = seqsl.sstart - window
                        e_pos = seqsl.sstart + window + seqsl.inslen
                    s_pos = max(s_pos, 0)
                    e_pos = min(e_pos, readlen)
                    if window < e_pos - s_pos < 100000:
                        if e_pos - s_pos > len(sv.consensus):
                            sv.consensus = sequence[s_pos:e_pos]
                            bp_fwd = ((readlen - seqsl.sstart
                                       - seqsl.inslen)
                                      if rec.flag & FREVERSE
                                      else seqsl.sstart)
                            sv.consBp = bp_fwd - s_pos

    # Align consensus sequences (asmode.h:380-452)
    target_lens = header.lengths
    for ref_index in range(header.n_targets):
        seq = None
        for ref_index2 in range(ref_index + 1):
            snd_seq = None
            for sv in svs:
                if sv.chr != ref_index:
                    continue
                if not sv.consensus:
                    sv.srSupport = 0
                    sv.srAlignQuality = 0
                    continue
                compute = False
                if is_translocation(sv.svt):
                    if ref_index2 != ref_index and sv.chr2 == ref_index2:
                        if snd_seq is None:
                            snd_seq = fasta.fetch(
                                header.names[ref_index2]).upper()
                        compute = True
                else:
                    if ref_index2 == ref_index and sv.chr2 == ref_index2:
                        compute = True
                if compute:
                    if seq is None:
                        seq = fasta.fetch(header.names[ref_index]).upper()
                    if sv.svt in (2, 4):
                        success = direct_indel_allele(
                            cfg, seq, target_lens[ref_index], sv)
                    else:
                        success = align_consensus(cfg, target_lens, seq,
                                                  snd_seq, sv,
                                                  realign=True)
                    if not success:
                        sv.consensus = ""
                        sv.srSupport = 0
                        sv.srAlignQuality = 0
        # Tag alleles + annotation
        for sv in svs:
            if sv.chr == ref_index and not sv.alleles:
                if seq is None:
                    seq = fasta.fetch(header.names[ref_index]).upper()
                sv.alleles = _add_alleles(
                    seq[sv.svStart - 1:sv.svStart],
                    header.names[sv.chr2], sv)
        for sv in svs:
            if (sv.chr == ref_index and sv.consensus
                    and not is_translocation(sv.svt)):
                if seq is None:
                    seq = fasta.fetch(header.names[ref_index]).upper()
                annotate_sv(cfg, target_lens, seq, sv)


def asm_merge_write(cfg, header, svs, sv_sample, sv_hap) -> None:
    """Cross-sample merge with haplotype-aware genotypes
    (asmode.h:464-668)."""
    stage("Merging SVs across samples")
    mc = MergeConfig(total_samples=cfg.nsamples, qualthres=0, vaf=0.0,
                     coverage=0, recurrent_samples=10)

    merged = []
    merged_hap = []
    for svt in range(2 * SVT_TRANS):
        nodes = []
        for i, sv in enumerate(svs):
            if sv.svt != svt or not sv.consensus or sv_sample[i] < 0:
                continue
            size = (sv.insLen if svt == 4
                    else abs(sv.svEnd - sv.svStart))
            comma = sv.alleles.find(",")
            ref_a = sv.alleles[:comma] if comma >= 0 else sv.alleles
            alt_a = sv.alleles[comma + 1:] if comma >= 0 else ""
            seq = ""
            if svt == 4:
                if (alt_a and alt_a[0] != "<" and len(alt_a) > 1
                        and size <= mc.seq_cutoff):
                    seq = alt_a[1:].upper()
            elif svt == 2:
                if len(ref_a) > 1 and size <= mc.seq_cutoff:
                    seq = ref_a[1:].upper()
            else:
                if sv.consensus and len(sv.consensus) <= mc.seq_cutoff:
                    seq = sv.consensus.upper()
            nodes.append(MergeSV(
                tid=sv.chr, mtid=sv.chr2, svStart=sv.svStart,
                svEnd=(sv.svStart + size if svt == 4 else sv.svEnd),
                pos2=sv.svEnd, size=size, svt=svt, homlen=sv.homLen,
                trperiod=sv.anno.trPeriod, score=sv.mapq,
                fileIdx=sv_sample[i], hap=sv_hap[i], supp=1, ac=1, sr=10,
                srmapq=sv.srMapQuality, altSupport=10,
                subtype=sv.anno.seqType,
                insStrand=((1 if sv.anno.isRC else 0)
                           if 1 <= sv.anno.seqType <= 6 else -1),
                precise=True, srq=sv.srAlignQuality, ce=2.0, id=str(i),
                seq=seq))
        if not nodes:
            continue
        groups = []
        cluster_and_select(mc, nodes, out_groups=groups)
        for rep, members, agg in groups:
            sv_idx = int(nodes[rep].id)
            rec = copy.copy(svs[sv_idx])
            rec.id = len(merged)
            rec.alleleid = agg.alleleId
            rec.nallele = agg.nAllele
            rec.ciposlow = agg.ciposLo
            rec.ciposhigh = agg.ciposHi
            rec.ciendlow = agg.ciendLo
            rec.ciendhigh = agg.ciendHi
            rec.srSupport = 10
            rec.mapq = svs[sv_idx].mapq * 10
            hb = [0] * cfg.nsamples
            for m in members:
                mn = nodes[m]
                if 0 <= mn.fileIdx < cfg.nsamples and mn.hap >= 0:
                    hb[mn.fileIdx] |= 1 << mn.hap
            merged.append(rec)
            merged_hap.append(hb)

    order = sorted(range(len(merged)),
                   key=lambda a: (merged[a].chr, merged[a].svStart))
    merged = [merged[i] for i in order]
    merged_hap = [merged_hap[i] for i in order]
    for i, rec in enumerate(merged):
        rec.id = i

    nsamples = cfg.nsamples
    jct_map = [[JunctionCount() for _ in merged] for _ in range(nsamples)]
    span_map = [[SpanningCount() for _ in merged]
                for _ in range(nsamples)]
    rc_map = [[ReadCount() for _ in merged] for _ in range(nsamples)]

    gt_qual = 30
    for nid in range(len(merged)):
        for s in range(nsamples):
            bits = merged_hap[nid][s]
            jc = jct_map[s][nid]
            if cfg.diploid:
                h0 = bool(bits & 1)
                h1 = bool(bits & 2)
                if not h0 and not h1:
                    jc.ref.extend([gt_qual, gt_qual])
                elif h0 and h1:
                    jc.alt.append(gt_qual)
                    jc.hp1alt.append(gt_qual)
                    jc.alt.append(gt_qual)
                    jc.hp2alt.append(gt_qual)
                else:
                    jc.ps = 1
                    if h0:
                        jc.alt.append(gt_qual)
                        jc.hp1alt.append(gt_qual)
                        jc.ref.append(gt_qual)
                        jc.hp2ref.append(gt_qual)
                    else:
                        jc.ref.append(gt_qual)
                        jc.hp1ref.append(gt_qual)
                        jc.alt.append(gt_qual)
                        jc.hp2alt.append(gt_qual)
            else:
                if bits:
                    jc.alt.append(gt_qual)
                    jc.ref.append(gt_qual)
                else:
                    jc.ref.extend([gt_qual, gt_qual])

    # Write via the standard VCF emitter, then k-way relabel loci
    tmpdir = tempfile.mkdtemp(prefix="delly_asm_")
    tmp_out = os.path.join(tmpdir, "asm.vcf")
    final_out = cfg.outfile
    cfg.outfile = tmp_out
    vcf_output(cfg, header, merged, jct_map, rc_map, span_map)
    cfg.outfile = final_out
    merge_bcfs(mc, [tmp_out], final_out)
    os.remove(tmp_out)
    os.rmdir(tmpdir)


def run_asm(cfg: AsmConfig) -> int:
    """asmode.h:670-700."""
    bams = [BamFile(f, genome=cfg.genome) for f in cfg.files]
    header = bams[0].header
    cfg.nchr = header.n_targets
    fasta = FastaFile(cfg.genome)

    # Sample/haplotype mapping (asmode.h:843-873)
    cfg.nsamples = (len(cfg.files) // 2 if cfg.diploid
                    else len(cfg.files))
    cfg.file_sample = []
    cfg.file_hap = []
    file_sm = []
    for file_c, bam in enumerate(bams):
        base = os.path.splitext(os.path.basename(cfg.files[file_c]))[0]
        file_sm.append(bam.header.sample_name(base))
        if cfg.diploid:
            cfg.file_sample.append(file_c // 2)
            cfg.file_hap.append(file_c % 2)
        else:
            cfg.file_sample.append(file_c)
            cfg.file_hap.append(0)
    cfg.sample_names = []
    cfg._ucount = 0
    for s in range(cfg.nsamples):
        f0 = 2 * s if cfg.diploid else s
        name = (common_sample_name(file_sm[f0], file_sm[f0 + 1])
                if cfg.diploid else file_sm[f0])
        while name in cfg.sample_names:
            # global counter across ALL samples (asmode.h:863-872)
            name = f"{name}_{cfg._ucount}"
            cfg._ucount += 1
        cfg.sample_names.append(name)

    svs = []
    sv_sample = []
    sv_hap = []
    sr_store = {}
    find_asm_structural_variants(cfg, bams, svs, sr_store, sv_sample,
                                 sv_hap)
    set_asm_consensus(cfg, bams, fasta, svs, sr_store)
    asm_merge_write(cfg, header, svs, sv_sample, sv_hap)
    stage("Done.")
    return 0

"""Long-read SV discovery and genotyping driver (delly lr).

Reference: src/tegua.h (runTegua / tegua). Pipeline:
split-read scan (junction.h findJunctions) -> typed junction pairing
(fetchSVs) -> per-svt clique clustering -> consensus assembly + breakpoint
refinement (assemble.h) -> positional dedup -> LR genotyping
(genotype.h) -> VCF output (modvcf.h).
"""

from __future__ import annotations

import sys


from delly_tpu_torch.io.bam import FDUP, FQCFAIL, FUNMAP, BamFile
from delly_tpu_torch.io.fasta import FastaFile
from delly_tpu_torch.models.assemble import SeqSlice, assemble
from delly_tpu_torch.models.genotype_lr import genotype_lr
from delly_tpu_torch.models.genotype_sr import (
    JunctionCount, ReadCount, SpanningCount,
)
from delly_tpu_torch.models.junctions import extract_junctions_lr, fetch_svs
from delly_tpu_torch.models.cluster import cluster_sr
from delly_tpu_torch.models.methyl import MethylInfo
from delly_tpu_torch.models.vcf_in import vcf_parse
from delly_tpu_torch.models.vcf_out import vcf_output
from delly_tpu_torch.utils.stats import parse_exclude_intervals
from delly_tpu_torch.utils.tags import SVT_TRANS


from delly_tpu_torch.utils.log import stage


def _log(msg: str) -> None:
    stage(msg)


def find_junctions(cfg, bams, valid_regions, valid_sr=None) -> dict:
    """Genome-wide split-read scan (junction.h:319-460). Secondary and
    supplementary alignments are kept; the per-read junction lists are
    keyed by the long-read name hash. With valid_sr, only those reads
    are considered (alternate-alignment filtering)."""
    import numpy as np

    from delly_tpu_torch.models.genotype_sr import _cigar_stats
    from delly_tpu_torch.utils.hashing import hash_lr_batch

    from delly_tpu_torch.parallel import hostaxis

    read_bp = {}
    _log("Split-read scanning")
    header = bams[0].header
    nproc = hostaxis.process_count()
    plan = [ri for ri in range(header.n_targets) if valid_regions[ri]]
    plan_mine = hostaxis.partition_plan(plan) if nproc > 1 else plan
    chrom_bp: dict = {}  # host-axis: per-chromosome partial read_bp
    for bam in bams:
        # pipeline upcoming chromosome view decodes behind the walk
        bam.set_decode_workers(getattr(cfg, "max_threads", 1) or 1,
                               plan_mine)
    for ref_index in plan_mine:
        if nproc > 1:
            read_bp = chrom_bp[ref_index] = {}
        for bam in bams:
            # SoA prefilter (junction.h:319-460): junctions can only
            # start at a clip > min_clip or an indel op > min_ref_sep,
            # so records without one are skipped without parsing.
            view = bam.chrom(ref_index)
            keep = (((view["flag"] & (FQCFAIL | FDUP | FUNMAP)) == 0)
                    & (view["mapq"] >= cfg.min_map_qual))
            sel = np.nonzero(keep)[0]
            offs = view["offsets"][sel]
            stats = _cigar_stats(view, offs)
            # sam_itr_queryi semantics (junction.h:347-352): reads
            # OVERLAPPING a valid interval are scanned, including long
            # reads starting before it
            pos_a = view["pos"][sel]
            end_a = pos_a + np.maximum(stats["ref_span"], 1)
            vmask = np.zeros(len(pos_a), dtype=bool)
            for lo, hi in valid_regions[ref_index]:
                vmask |= (pos_a < hi) & (end_a > lo)
            sel = sel[vmask]
            offs = offs[vmask]
            stats = {k: v[vmask] for k, v in stats.items()}
            jfire = np.nonzero((stats["max_clip"] > cfg.min_clip)
                               | (stats["max_indel"]
                                  > cfg.min_ref_sep))[0]
            # scalarize only the firing subset (full-column tolist is
            # O(reads) Python objects)
            seeds_j = hash_lr_batch(stats["name_hash"][jfire],
                                    stats["fnv_hash"][jfire]).tolist()
            offs_j = offs[jfire].tolist()
            for k in range(len(offs_j)):
                seed = seeds_j[k]
                if valid_sr and seed not in valid_sr:
                    continue
                rec = view.parse_at(offs_j[k])
                extract_junctions_lr(read_bp, seed, rec, cfg.min_ref_sep,
                                     cfg.min_clip, cfg.indel_extension)
    if nproc > 1:
        # merge per-chromosome partials in plan order (serial append
        # order), then sort per seed exactly like the serial scan
        merged = hostaxis.exchange_owned(chrom_bp)
        read_bp = {}
        for ref_index in plan:
            for seed, jl in merged.get(ref_index, {}).items():
                read_bp.setdefault(seed, []).extend(jl)
    for jv in read_bp.values():
        jv.sort(key=lambda j: j.sort_key())
    return read_bp


def _find_sr_breakpoints(cfg, bams, valid_regions, sr_br,
                         valid_sr=None) -> None:
    """junction.h:488-492."""
    read_bp = find_junctions(cfg, bams, valid_regions, valid_sr)
    fetch_svs(read_bp, sr_br, cfg.svtset, cfg.max_read_sep,
              cfg.min_ref_sep)


def _alt_alignment_filter(cfg, sr_br: list) -> None:
    """Keep only split reads whose breakpoints recur in alternate
    linear (BAM) or graph (GFA/GAF) alignments (junction.h:504-588)."""
    import copy

    from delly_tpu_torch.models.pangenome import (
        find_graph_sr_breakpoints, is_bam_cram, parse_alternate_alignments,
        parse_gfa,
    )
    valid_sr = set()
    for svt_recs in sr_br:
        for r in svt_recs:
            valid_sr.add(r.id)
    align, genomes = parse_alternate_alignments(cfg.altfile)
    nsvt = len(sr_br)
    for alt_path, alt_genome in zip(align, genomes):
        _log(f"Parsing alternate alignment {alt_path}")
        alt_sr = [[] for _ in range(nsvt)]
        alt_cfg = copy.copy(cfg)
        alt_cfg.exclude = ""
        alt_cfg.genome = alt_genome
        alt_cfg.altfile = ""
        if is_bam_cram(alt_path):
            # decode against the ALTERNATE genome (junction.h:524-537
            # hts_set_fai_filename with genome[i]) — CRAMs referenced
            # to the alt assembly decode wrongly against the primary
            alt_bam = BamFile(alt_path, genome=alt_genome)
            alt_regions = parse_exclude_intervals(None, alt_bam.header)
            _find_sr_breakpoints(alt_cfg, [alt_bam], alt_regions, alt_sr,
                                 valid_sr)
        else:
            g = parse_gfa(alt_genome)
            alt_cfg.nchr = len(g.smap)
            # Minigraph lacks alignment extension: larger BP separation
            alt_cfg.max_read_sep = 2000
            find_graph_sr_breakpoints(alt_cfg, g, [alt_path], alt_sr,
                                      valid_sr)
        new_valid = set()
        for svt_recs in alt_sr:
            for r in svt_recs:
                if r.id in valid_sr:
                    new_valid.add(r.id)
        valid_sr = new_valid
    orig = sum(len(s) for s in sr_br)
    for svt in range(nsvt):
        sr_br[svt] = [r for r in sr_br[svt] if r.id in valid_sr]
    new = sum(len(s) for s in sr_br)
    ratio = (orig - new) / orig if orig else 0.0
    _log(f"Filtered {orig - new} out of {orig} split-read records "
         f"({ratio * 100:.1f}%)")


def cluster_sr_reads(cfg, bams, valid_regions, svc: list, sr_store: list):
    """junction.h:495-623 (_clusterSRReads): scan -> fetchSVs ->
    [alternate-alignment filter] -> per-svt clustering -> split-read
    store for assembly."""
    header = bams[0].header
    nsvt = 2 * SVT_TRANS
    sr_br = [[] for _ in range(nsvt)]
    _find_sr_breakpoints(cfg, bams, valid_regions, sr_br)
    if cfg.altfile:
        _alt_alignment_filter(cfg, sr_br)

    for svt in range(nsvt):
        if not sr_br[svt]:
            continue
        sr_br[svt].sort(key=lambda r: r.sort_key())
        cluster_sr(sr_br[svt], svc, svt, cfg.nchr, cfg.max_read_sep,
                   cfg.graph_pruning, cfg.min_clique_size)
        # Track split reads for consensus assembly (junction.h:603-622)
        for r in sr_br[svt]:
            if r.svid != -1 and r.rstart != -1:
                insert_chr = r.primaryChr if r.primaryChr != -1 else r.chr
                if r.rstart < header.lengths[insert_chr]:
                    sr_store[insert_chr].setdefault(
                        (r.rstart, r.id), []).append(
                            SeqSlice(r.svid, r.sstart, r.inslen, r.qual))


def run_lr(cfg) -> int:
    """tegua.h:77-207."""
    bams = [BamFile(f, genome=cfg.genome) for f in cfg.files]
    header = bams[0].header
    cfg.nchr = header.n_targets
    if not cfg.sample_names:
        cfg.sample_names = [
            b.header.sample_name(default=f.rsplit("/", 1)[-1].split(".")[0])
            for b, f in zip(bams, cfg.files)]
    fasta = FastaFile(cfg.genome)
    try:
        valid_regions = parse_exclude_intervals(cfg.exclude or None,
                                                header)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 1

    svs = []
    if not cfg.vcffile:
        svc = []
        sr_store = [dict() for _ in range(cfg.nchr)]
        cluster_sr_reads(cfg, bams, valid_regions, svc, sr_store)
        _log("Split-read assembly")
        assemble(cfg, bams, fasta, valid_regions, svc, sr_store)

        # Sort + dedup (tegua.h:124-149)
        svc.sort(key=lambda s: s.sort_key())
        last_sv_per_type = {}
        for sv in svc:
            if sv.srSupport == 0 and sv.peSupport == 0:
                continue
            if svs:
                last = last_sv_per_type.get(sv.svt)
                if (last is not None and last.chr == sv.chr
                        and last.chr2 == sv.chr2
                        and abs(sv.svStart - last.svStart) < cfg.min_ref_sep
                        and abs(sv.svEnd - last.svEnd) < cfg.min_ref_sep):
                    len1 = (sv.insLen if sv.svt == 4
                            else sv.svEnd - sv.svStart)
                    len2 = (last.insLen if last.svt == 4
                            else last.svEnd - last.svStart)
                    lengthvar = int(min(0.1 * len1, 0.1 * len2))
                    if lengthvar < 15:
                        lengthvar = 15
                    if abs(len1 - len2) < lengthvar:
                        continue
            last_sv_per_type[sv.svt] = sv
            svs.append(sv)
        svs.sort(key=lambda s: s.sort_key())
        for i, sv in enumerate(svs):
            sv.id = i
    else:
        svs = vcf_parse(cfg.vcffile, header)

    n_files = len(cfg.files)
    jct_map = [[JunctionCount() for _ in svs] for _ in range(n_files)]
    span_map = [[SpanningCount() for _ in svs] for _ in range(n_files)]
    rc_map = [[ReadCount() for _ in svs] for _ in range(n_files)]
    methyl_map = [[MethylInfo() for _ in svs] for _ in range(n_files)]

    genotype_lr(cfg, bams, fasta, svs, jct_map, rc_map, methyl_map)
    from delly_tpu_torch.parallel import hostaxis
    if hostaxis.is_writer():
        vcf_output(cfg, header, svs, jct_map, rc_map, span_map,
                   methyl_map)
    hostaxis.barrier("lr-done")
    _log("Done.")
    return 0

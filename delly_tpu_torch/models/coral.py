"""Read-depth CNV driver (delly cnv).

Reference: src/coral.h (bamCount / coral). Pipeline: library stats ->
coverage-aware GC scan window -> 10kb window scan + CN2-stable selection
-> GC bias curve + correctable bounds -> auto window size targeting
~150 reads/window -> regional GC correction -> main counting pass per
chromosome (GC track, coverage + uniq-MAPQ tracks, split-read clips,
callable masks) -> segmentation + CNV genotyping -> merge -> CNV VCF
plus the gzipped logR/CN coverage table.
"""

from __future__ import annotations

import gzip
import io
import os
import sys
from dataclasses import dataclass, field

import numpy as np

from delly_tpu_torch.io.bam import (
    FDUP, FMUNMAP, FPAIRED, FQCFAIL, FSECONDARY, FSUPPLEMENTARY, FUNMAP,
    BamFile,
)
from delly_tpu_torch.io.fasta import FastaFile
from delly_tpu_torch.models.cnv import (
    cnv_vcf, collect_breakpoints, genotype_cnvs, merge_adjacent_same_cn,
    parse_vcf_cnv, segment_rd, uniq_threshold,
)
from delly_tpu_torch.models.depth import (
    add_split_read_breakpoints, base_coverage_bulk, gc_content_track,
    set_min_chr_len, uniq_content_track,
)
from delly_tpu_torch.models.gcbias import (
    GcBias, estimate_regional_gc, gc_bias, reg_corr_factor,
)
from delly_tpu_torch.models.scan import scan, select_windows
from delly_tpu_torch.utils.hashing import hash_sr_batch
from delly_tpu_torch.utils.stats import get_library_params
from delly_tpu_torch.utils.log import stage


@dataclass
class CnvConfig:
    """delly cnv options (coral.h:26-71, defaults coral.h:445-498)."""
    genome: str = ""
    bam_file: str = ""
    outfile: str = "-"
    covfile: str = ""
    segfile: str = ""
    genofile: str = ""
    stats_file: str = ""
    scan_file: str = ""
    sample_name: str = ""
    min_qual: int = 10
    min_cnv_size: int = 1000
    min_clip: int = 25
    min_ref_sep: int = 30
    min_bp_support: int = 3
    penalty: float = 3.0
    cn_merge_tol: float = 0.25
    cn_min_callable: float = 0.75
    ploidy: float = 2.0
    purity: float = 1.0
    ctrl_ploidy: float = 2.0
    haploid_chr: str = ""
    window_size: int = 0
    window_offset: int = 0
    scan_window: int = 10000
    scan_window_user_set: bool = False
    unique_to_total_cov_ratio: float = 0.8
    fragment_unique: float = 0.97
    frac_window: float = 0.25
    mapq_uniq: int = 20
    target_reads: int = 150
    mad: int = 3
    exclgc: float = 0.0005
    no_scan_window_selection: bool = False
    regional_gc: bool = True
    basecov_flag: str = "auto"  # auto | base | fragment
    # derived
    basecov: bool = False
    adaptive: bool = False
    target_exp_cov: float = 0.0
    expected_cn: float = 2.0
    meanisize: int = 251
    min_chr_len: int = 0
    nchr: int = 0
    ref_idx: set = field(default_factory=set)

    def __post_init__(self):
        # These are C floats in the reference (coral.h:39-60); boundary
        # comparisons must see the f32-rounded values (see config._f32).
        from delly_tpu_torch.models.config import _f32
        _f32("penalty", "cn_merge_tol", "cn_min_callable", "ploidy",
             "purity", "ctrl_ploidy", "unique_to_total_cov_ratio",
             "fragment_unique", "frac_window", "exclgc")(self)
        import numpy as np
        self.purity = float(min(max(np.float32(self.purity),
                                    np.float32(0.1)), np.float32(1.0)))
        # coral.h:553 mixes f32 products with a double 1.0 term, then
        # stores the sum back into the float expectedCN
        p32 = np.float32(self.purity)
        self.expected_cn = float(np.float32(
            float(p32 * np.float32(self.ploidy))
            + (1.0 - float(p32)) * float(np.float32(self.ctrl_ploidy))))
        if self.target_reads == 0:
            self.target_reads = 150
        self.adaptive = self.window_size == 0
        if self.window_offset == 0 or self.window_offset > self.window_size:
            self.window_offset = self.window_size


def _mapped_stats(bam) -> tuple:
    """Total mapped reads and covered genome length (role of
    hts_idx_get_stat in coral.h:679-690). Streaming mode reads the
    index's metadata pseudo-bins (hts_idx_get_stat's source) or falls
    back to a bounded-memory chunked SoA scan."""
    if getattr(bam, "streaming", False):
        total = 0
        genome_len = 0
        bai = getattr(bam, "_bai", None)  # streaming CRAM has no .bai
        counted = bai is not None
        for tid in range(bam.header.n_targets if counted else 0):
            n = bai.mapped_stat(tid)
            if n is None:
                counted = False
                break
            if n > 0:
                total += n
                genome_len += bam.header.lengths[tid]
        if counted:
            return total, genome_len
        total = 0
        seen = set()
        for view in bam.iter_soa_chunks():
            tids = view["tid"]
            mask = ((view["flag"] & FUNMAP) == 0) & (tids >= 0)
            total += int(np.count_nonzero(mask))
            seen.update(np.unique(tids[mask]).tolist())
        genome_len = int(sum(bam.header.lengths[int(t)] for t in seen))
        return total, genome_len
    idx = bam.core_index()
    mapped = (idx["flag"] & FUNMAP) == 0
    tids = idx["tid"]
    mask = mapped & (tids >= 0)
    total = int(np.count_nonzero(mask))
    seen = np.unique(tids[mask])
    genome_len = int(sum(bam.header.lengths[int(t)] for t in seen))
    return total, genome_len


def bam_count(cfg, bam, fasta, li, gcbias, gcbound, regcorr, reg_win) -> int:
    """Main counting pass (coral.h:93-437).

    Host-axis mode: each process counts only its owned chromosomes;
    the per-chromosome products (discovered+genotyped CNVs, genofile
    record updates, rendered covfile text block) are exchanged and
    stitched in chromosome order, and process 0 alone writes the
    covfile and the CNV BCF."""
    from delly_tpu_torch.parallel import hostaxis

    header = bam.header
    stage("Count fragments")
    nproc = hostaxis.process_count()

    data_out = None
    if cfg.covfile and hostaxis.is_writer():
        data_out = gzip.open(cfg.covfile, "wt")
        data_out.write(f"chr\tstart\tend\t{cfg.sample_name}_uniqfrac\t"
                       f"{cfg.sample_name}_logR\t{cfg.sample_name}_CN\n")

    cnvs = []
    if cfg.genofile:
        cnvs = parse_vcf_cnv(cfg.genofile, header)

    cov_curve = np.asarray([gb.coverage for gb in gcbias])
    regcorr_arr = regcorr or []

    from delly_tpu_torch.io.bam import default_decode_workers
    bam.set_decode_workers(default_decode_workers())
    plan = [ri for ri in range(header.n_targets)
            if (cfg.genofile or bam.mapped_count(ri))
            and fasta.has_seq(header.names[ri])]
    plan_mine = hostaxis.partition_plan(plan) if nproc > 1 else plan
    products: dict = {}
    for ref_index in plan_mine:
        chrom_cnvs = cnvs if (cfg.genofile or nproc == 1) else []
        chrom_out = io.StringIO() if (cfg.covfile and nproc > 1) \
            else data_out
        name = header.names[ref_index]
        reflen = header.lengths[ref_index]
        chr_ctrl_ploidy = cfg.ctrl_ploidy
        chr_ploidy = cfg.ploidy
        if ref_index in cfg.ref_idx:
            chr_ctrl_ploidy -= 1
            chr_ploidy -= 1
        seq = fasta.fetch(name)
        gc_content = gc_content_track(seq, cfg.meanisize, key=(cfg.genome, name))

        # Broad-tile regional correction factors (coral.h:164-179).
        # float32 storage: the reference keeps std::vector<float>
        # tileFac and widens per multiply (coral.h:166,177)
        tile_fac = np.zeros(0, dtype=np.float32)
        if regcorr_arr and reg_win > 0:
            ntile = reflen // reg_win + 1
            tile_fac = np.ones(ntile, dtype=np.float32)
            in_range = ((gc_content > gcbound[0])
                        & (gc_content < gcbound[1]))
            for t in range(ntile):
                s = t * reg_win
                e = min(reflen, s + reg_win)
                m = in_range[s:e]
                winlen = int(np.count_nonzero(m))
                if winlen > 0:
                    gcnum = float(gc_content[s:e][m].astype(np.int64).sum())
                    tile_fac[t] = reg_corr_factor(
                        regcorr_arr, (gcnum / winlen) / cfg.meanisize)

        cov = np.zeros(reflen, dtype=np.uint16)
        cov_uniq = np.zeros(reflen, dtype=np.uint16)
        cov_tot = None if cfg.basecov else np.zeros(reflen, dtype=np.uint16)
        cov_map = cov if cfg.basecov else cov_tot

        clips = []
        # SoA-driven counting pass (coral.h:182-294)
        view = bam.chrom(ref_index)
        flag_a = view["flag"]
        keep = (((flag_a & (FQCFAIL | FDUP | FUNMAP | FSECONDARY
                            | FSUPPLEMENTARY)) == 0)
                & (view["mapq"] >= cfg.min_qual)
                & ~(((flag_a & FPAIRED) != 0)
                    & (((flag_a & FMUNMAP) != 0)
                       | (view["mtid"] != ref_index))))
        sel = np.nonzero(keep)[0]
        offs = view["offsets"][sel]
        from delly_tpu_torch.models.genotype_sr import _cigar_stats
        stats = _cigar_stats(view, offs)
        flag_a = view["flag"][sel]
        mapq_a = view["mapq"][sel]
        # split-read breakpoint collection (prefiltered CIGAR walk)
        clipfire = ((mapq_a >= cfg.mapq_uniq)
                    & ((stats["max_clip"] > cfg.min_clip)
                       | (stats["max_indel"] > cfg.min_ref_sep)))
        # scalarize only the firing subset (full-column tolist is
        # O(reads) Python objects)
        for off in offs[clipfire].tolist():
            add_split_read_breakpoints(view.parse_at(off),
                                       cfg.min_clip, cfg.min_ref_sep,
                                       reflen, clips)
        bc = base_coverage_bulk(view, offs, cfg.mapq_uniq, reflen)
        if cfg.basecov:
            np.minimum(bc[0], 65534, out=bc[0])
            cov = bc[0].astype(np.uint16)
        else:
            np.minimum(bc[0], 65534, out=bc[0])
            cov_tot = bc[0].astype(np.uint16)
        np.minimum(bc[1], 65534, out=bc[1])
        cov_uniq = bc[1].astype(np.uint16)
        cov_map = cov if cfg.basecov else cov_tot
        if not cfg.basecov:
            from delly_tpu_torch.models.pairing import (
                first_obs_mask, match_store_pop,
                saturating_midpoint_counts,
            )
            from delly_tpu_torch.utils.hashing import hash_pair_h_batch
            seeds_a = hash_sr_batch(stats["name_hash"],
                                    stats["fnv_hash"], flag_a)
            pos_a = view["pos"][sel]
            mpos_a = view["mpos"][sel]
            nh_a = stats["name_hash"]
            rspan_a = stats["ref_span"]
            paired_a = (flag_a & FPAIRED) != 0
            mids = []
            pr = np.nonzero(paired_a)[0]
            if len(pr):
                refs = np.full(len(pr), ref_index, dtype=np.int64)
                # first_pair_obs (tags.h:269-274): probe with
                # hash_string, insert the hash_sr seed
                p_first = first_obs_mask(pos_a[pr],
                                         pos_a[pr] < mpos_a[pr],
                                         pos_a[pr] == mpos_a[pr],
                                         nh_a[pr], seeds_a[pr])
                hv1 = hash_pair_h_batch(nh_a[pr], refs, pos_a[pr], refs,
                                        mpos_a[pr])
                hv2 = hash_pair_h_batch(nh_a[pr], refs, mpos_a[pr],
                                        refs, pos_a[pr])
                keys = np.where(p_first, hv1, hv2)
                S_loc, _F = match_store_pop(keys, p_first)
                S = pr[S_loc]
                isize = pos_a[S] + rspan_a[S] - mpos_a[S]
                inb = ((isize > li.minNormalISize)
                       & (isize < li.maxNormalISize))
                mids.append(np.where(inb, mpos_a[S] + isize // 2,
                                     pos_a[S] + rspan_a[S] // 2))
            up = np.nonzero(~paired_a)[0]
            if len(up):
                mids.append(pos_a[up] + rspan_a[up] // 2)
            if mids:
                cov = saturating_midpoint_counts(
                    np.concatenate(mids), reflen)

        uniq_content = uniq_content_track(cov_map, cov_uniq, seq,
                                          cfg.meanisize)

        chrbp = collect_breakpoints(cfg, gcbound, gc_content, uniq_content,
                                    gcbias, cov, reflen, clips)
        if not cfg.genofile:
            segment_rd(cfg, gcbound, gc_content, uniq_content, gcbias,
                       tile_fac, reg_win, cov, reflen, ref_index, chrbp,
                       chrom_cnvs)
        genotype_cnvs(cfg, gcbound, gc_content, uniq_content, gcbias,
                      tile_fac, reg_win, cov, cov_uniq, cov_map, reflen,
                      ref_index, chrom_cnvs)

        # Genome-wide read-depth windows (coral.h:296-414)
        if chrom_out is not None:
            _write_windows(cfg, chrom_out, name, reflen, gcbound, gc_content,
                           uniq_content, cov, cov_uniq, cov_map, cov_curve,
                           tile_fac, reg_win, chr_ploidy, chr_ctrl_ploidy)
        if nproc > 1:
            products[ref_index] = (
                None if cfg.genofile else chrom_cnvs,
                ({i: c for i, c in enumerate(cnvs) if c.chr == ref_index}
                 if cfg.genofile else None),
                chrom_out.getvalue() if cfg.covfile else None)

    if nproc > 1:
        # stitch the exchanged per-chromosome products in serial order
        merged = hostaxis.exchange_owned(products)
        if cfg.genofile:
            for ri in plan:
                ent = merged.get(ri)
                if ent and ent[1]:
                    for i, c in ent[1].items():
                        cnvs[i] = c
        else:
            cnvs = []
            for ri in plan:
                ent = merged.get(ri)
                if ent and ent[0]:
                    cnvs.extend(ent[0])
        if data_out is not None:
            for ri in plan:
                ent = merged.get(ri)
                if ent and ent[2]:
                    data_out.write(ent[2])

    cnvs.sort(key=lambda c: c.sort_key())
    if not cfg.genofile:
        cnvs = merge_adjacent_same_cn(cnvs, cfg.cn_merge_tol)
    if hostaxis.is_writer():
        cnv_vcf(cfg, header, cnvs)

    if data_out is not None:
        data_out.close()
    hostaxis.barrier("cnv-done")
    return 0


def _seq_sums(x, starts, ends):
    """Left-to-right sequential per-range float64 sums — the
    reference's per-window running-sum rounding (coral.h:296-339).
    Native core with an exact Python fallback."""
    try:
        from delly_tpu_torch import native
        out = native.seq_range_sums(x, starts, ends)
        if out is not None:
            return out
    except Exception:
        pass
    xl = np.asarray(x, dtype=np.float64)
    out = np.empty(len(starts), dtype=np.float64)
    for k in range(len(starts)):
        s = 0.0
        for v in xl[int(starts[k]):int(ends[k])].tolist():
            s += v
        out[k] = s
    return out


def _bounded_sums(x, bounds, dtype=None):
    """Sums of x over [bounds[k], bounds[k+1]) for a strictly
    increasing boundary chain. Integer-valued inputs (declared via an
    integer `dtype`) take one np.add.reduceat pass — exact in any
    order; float inputs accumulate sequentially per window like the
    reference's running sums (pairwise summation differs in the last
    ulp)."""
    if dtype is not None and np.issubdtype(np.dtype(dtype), np.integer):
        if bounds[-1] >= len(x):
            return np.add.reduceat(x, bounds[:-1], dtype=dtype)
        return np.add.reduceat(x, bounds, dtype=dtype)[:-1]
    b = np.asarray(bounds, dtype=np.int64)
    return _seq_sums(x, b[:-1], b[1:])


def _range_sums(x, starts, ends, dtype=None):
    """Sums over [starts[i], ends[i]): reduceat for integer-valued
    inputs on contiguous windows, sequential per-range accumulation
    otherwise (reference rounding; handles overlapping user windows)."""
    if len(starts) == 0:
        return np.zeros(0, dtype=dtype or np.float64)
    if (dtype is not None and np.issubdtype(np.dtype(dtype), np.integer)
            and np.all(starts[1:] == ends[:-1])):
        bounds = np.append(starts, ends[-1])
        return _bounded_sums(x, bounds, dtype=dtype)
    return _seq_sums(x, starts, ends)


def _write_windows(cfg, data_out, chrn, reflen, gcbound, gc_content,
                   uniq_content, cov, cov_uniq, cov_map, cov_curve,
                   tile_fac, reg_win, chr_ploidy, chr_ctrl_ploidy):
    """Adaptive or fixed logR/CN windows + hom-del vs unmappable
    separation (coral.h:296-414)."""
    valid = ((gc_content > gcbound[0]) & (gc_content < gcbound[1])
             & (uniq_content >= uniq_threshold(cfg)))
    wins = []  # (start, end, winlen, covsum, expcov, ucov, tcov, valid)
    if cfg.adaptive:
        vpos = np.nonzero(valid)[0]
        nv = len(vpos)
        e1 = cov_curve[gc_content[vpos].astype(np.int64)] if nv else []
        if nv and len(tile_fac):
            ecor = e1 * tile_fac[vpos // reg_win]
        elif nv:
            ecor = e1
        craw = np.concatenate(([0.0], np.cumsum(e1))) if nv else [0.0]
        # greedy boundary chain, then all window sums vectorized
        bidx = [0]
        i = 0
        while i < nv:
            j = int(np.searchsorted(craw, craw[i] + cfg.target_exp_cov,
                                    side="left"))
            if j > nv:
                break
            bidx.append(j)
            i = j
        if len(bidx) > 1:
            b = np.asarray(bidx, dtype=np.int64)
            ends = vpos[b[1:] - 1] + 1
            starts = np.concatenate(([0], ends[:-1]))
            wins = list(zip(
                starts.tolist(), ends.tolist(), (b[1:] - b[:-1]).tolist(),
                _bounded_sums(cov[vpos], b,
                              dtype=np.float64).tolist(),
                _bounded_sums(ecor, b).tolist(),
                _range_sums(cov_uniq, starts, ends,
                            dtype=np.float64).tolist(),
                _range_sums(cov_map, starts, ends,
                            dtype=np.float64).tolist(),
                [True] * (len(b) - 1)))
    else:
        starts = np.arange(0, reflen, cfg.window_offset, dtype=np.int64)
        starts = starts[starts + cfg.window_size < reflen]
        ends = starts + cfg.window_size
        evals = np.where(valid, cov_curve[gc_content.astype(np.int64)], 0.0)
        if len(tile_fac):
            pos_all = np.arange(reflen)
            evals = evals * np.where(valid, tile_fac[pos_all // reg_win], 1.0)
        winlen = _range_sums(valid, starts, ends, dtype=np.int64)
        wins = list(zip(
            starts.tolist(), ends.tolist(), winlen.tolist(),
            _range_sums(np.where(valid, cov, 0), starts, ends,
                        dtype=np.float64).tolist(),
            _range_sums(evals, starts, ends).tolist(),
            _range_sums(cov_uniq, starts, ends,
                        dtype=np.float64).tolist(),
            _range_sums(cov_map, starts, ends,
                        dtype=np.float64).tolist(),
            (winlen >= cfg.frac_window * cfg.window_size).tolist()))

    nw = len(wins)
    if not nw:
        return
    cols = np.asarray(wins, dtype=np.float64)
    start_i = cols[:, 0].astype(np.int64)
    end_i = cols[:, 1].astype(np.int64)
    winlen = cols[:, 2]
    covsum = cols[:, 3]
    expcov = cols[:, 4]
    ucov = cols[:, 5]
    tcov = cols[:, 6]
    validw = cols[:, 7] != 0

    # hom-del vs unmappable separation (coral.h:352-384), vectorized:
    # maximal runs of suspect windows are disjoint and separated by at
    # least one non-suspect window, so per-run neighbor checks read
    # state no other run can have modified — identical to the
    # reference's sequential sweep.
    low_frac = 0.1
    flank_frac = 0.5
    max_hom_del_win = 1000000
    na_flag = ~validw | (expcov <= 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(expcov > 0, covsum / np.where(expcov > 0, expcov, 1.0),
                     0.0)
    suspect = ~na_flag & (r < low_frac)
    strong = ~na_flag & (r >= flank_frac)
    run_edge = np.flatnonzero(np.diff(np.r_[False, suspect, False]))
    for a, b1 in zip(run_edge[0::2], run_edge[1::2]):
        b = b1 - 1
        run_bp = end_i[b] - start_i[a]
        left_strong = a > 0 and not na_flag[a - 1] and strong[a - 1]
        right_strong = b + 1 < nw and not na_flag[b + 1] and strong[b + 1]
        if not (left_strong and right_strong and run_bp <= max_hom_del_win):
            na_flag[a:b + 1] = True

    uniq_gate = cfg.basecov
    if uniq_gate:
        na_flag |= ((tcov > 0)
                    & (ucov <= cfg.unique_to_total_cov_ratio * tcov))

    if uniq_gate:
        uniq_frac = np.where(tcov > 0, ucov / np.where(tcov > 0, tcov, 1.0),
                             -1.0)
    else:
        span = (end_i - start_i).astype(np.float64)
        uniq_frac = np.where(span > 0, winlen / np.where(span > 0, span, 1.0),
                             -1.0)

    ok = ~na_flag
    from delly_tpu_torch.parallel import dispatch
    mesh = dispatch.get_mesh()
    if mesh is not None:
        # production multi-chip: the per-window depth math runs
        # elementwise (float64) over the window axis sharded across the
        # mesh — bit-identical for any device count by construction —
        # with psum'd integer-exact callable/coverage tallies.
        from delly_tpu_torch.parallel.depth_step import depth_windows_on_mesh
        cn_arr, logr_arr, (n_call, cov_tot) = depth_windows_on_mesh(
            mesh, covsum, expcov, ok, cfg.expected_cn, cfg.purity,
            chr_ctrl_ploidy, chr_ploidy)
        from delly_tpu_torch.utils import log
        log.stage(f"Mesh read-depth windows, chr={chrn}, "
                  f"devices={int(mesh.devices.size)}, windows={nw}, "
                  f"callable={n_call}, coverage={cov_tot:g}")
    else:
        # shared depth math (ops/depth_math.py) — the same function the
        # sharded multi-chip step executes, so the mesh path cannot
        # drift from production semantics (coral.h:296-414 doubles).
        from delly_tpu_torch.ops.depth_math import window_depth
        cn_arr, logr_arr = window_depth(
            np, covsum, np.where(ok, expcov, 0.0), cfg.expected_cn,
            cfg.purity, chr_ctrl_ploidy, chr_ploidy)

    # batch row rendering: native snprintf plane (byte-identical %g)
    # with a Python fallback — a WGS run emits ~3M windows and the
    # per-row f-string loop is minutes of interpreter time at scale
    from delly_tpu_torch import native
    text = native.cov_rows(chrn, start_i, end_i, uniq_frac,
                           np.where(na_flag, 0.0, logr_arr),
                           np.where(na_flag, 0.0, cn_arr), na_flag)
    if text is not None:
        data_out.write(text)
    else:
        rows = []
        for i in range(nw):
            if na_flag[i]:
                rows.append(f"{chrn}\t{start_i[i]}\t{end_i[i]}\t"
                            f"{uniq_frac[i]:g}\tNA\tNA\n")
            else:
                rows.append(f"{chrn}\t{start_i[i]}\t{end_i[i]}\t"
                            f"{uniq_frac[i]:g}\t{logr_arr[i]:g}\t"
                            f"{cn_arr[i]:g}\n")
        data_out.write("".join(rows))


def run_cnv(cfg) -> int:
    """coral.h:440-832."""
    bam = BamFile(cfg.bam_file, genome=cfg.genome)
    header = bam.header
    fasta = FastaFile(cfg.genome)
    cfg.nchr = header.n_targets
    cfg.min_chr_len = set_min_chr_len(header.lengths, 0.95)
    if not cfg.sample_name:
        base = os.path.splitext(os.path.basename(cfg.bam_file))[0]
        cfg.sample_name = header.sample_name(base)
    if cfg.haploid_chr:
        for tok in cfg.haploid_chr.split(","):
            tid = header.name2id(tok)
            if tid >= 0:
                cfg.ref_idx.add(tid)

    # Library parameters over all (or scan) regions
    if cfg.scan_file:
        from delly_tpu_torch.models.bed import parse_bed_intervals
        scan_regions = parse_bed_intervals(cfg.scan_file, header)
    else:
        scan_regions = [[(0, ln)] for ln in header.lengths]
    li = get_library_params(bam, scan_regions, 9, cfg.mad)
    paired_lib = li.median > 0
    if not li.median:
        li.median = 250
        li.mad = 15
        li.minNormalISize = 0
        li.maxNormalISize = 400
    cfg.meanisize = (li.median // 2) * 2 + 1

    # Coverage-aware GC scan window (coral.h:677-701)
    if not cfg.scan_window_user_set:
        total_mapped, genome_len = _mapped_stats(bam)
        if paired_lib:
            total_mapped //= 2
        if total_mapped > 0 and genome_len > 0:
            frag_per_bp = total_mapped / genome_len
            auto_scan = int(30 / frag_per_bp)
            auto_scan = min(max(auto_scan, cfg.scan_window), 1000000)
            if auto_scan > cfg.scan_window:
                cfg.scan_window = auto_scan

    # Counting model (coral.h:709-712)
    if cfg.basecov_flag == "base":
        cfg.basecov = True
    elif cfg.basecov_flag == "fragment":
        cfg.basecov = False
    else:
        cfg.basecov = (not paired_lib) and li.rs >= 500

    gcbias = [GcBias() for _ in range(cfg.meanisize + 1)]
    scan_counts = [[] for _ in range(cfg.nchr)]
    scan(cfg, bam, fasta, li, scan_counts)

    # sampled median: stop after the chromosome that crosses 1M windows
    # (coral.h:727-733 break)
    sample_scan = []
    for chrom in scan_counts:
        sample_scan.extend(w.cov for w in chrom)
        if len(sample_scan) > 1_000_000:
            break
    if not sample_scan:
        stage("Not enough windows!")
        return 1
    sample_scan.sort()
    if sample_scan[len(sample_scan) // 2] < 5:
        stage("Coverage in the GC scan window is too low.")
        return 1

    select_windows(cfg, scan_counts)
    gcbound = gc_bias(cfg, bam, fasta, scan_counts, li, gcbias)

    from delly_tpu_torch.parallel import hostaxis
    if cfg.stats_file and hostaxis.is_writer():
        with gzip.open(cfg.stats_file, "wt") as stats:
            stats.write(f"LP\t{li.rs},{li.median},{li.mad},"
                        f"{li.minNormalISize},{li.maxNormalISize}\n")
            stats.write("SW\tchrom\tstart\tend\tselected\tcoverage\t"
                        "uniqcov\n")
            for ref_index in range(header.n_targets):
                for w in scan_counts[ref_index]:
                    stats.write(f"SW\t{header.names[ref_index]}\t{w.start}"
                                f"\t{w.end}\t{int(w.select)}\t{w.cov}\t"
                                f"{w.uniqcov}\n")
            stats.write("GC\tgcsum\tsample\treference\tpercentileSample\t"
                        "percentileReference\tfractionSample\t"
                        "fractionReference\tobsexp\tmeancoverage\n")
            for i, gb in enumerate(gcbias):
                stats.write(f"GC\t{i}\t{gb.sample}\t{gb.reference}\t"
                            f"{gb.percentileSample:g}\t"
                            f"{gb.percentileReference:g}\t"
                            f"{gb.fractionSample:g}\t"
                            f"{gb.fractionReference:g}\t{gb.obsexp:g}\t"
                            f"{gb.coverage:g}\n")
            stats.write(f"BoundsGC\t{gcbound[0]},{gcbound[1]}\n")

    # Coverage-aware window size (coral.h:782-814)
    eff_win = cfg.window_size if cfg.window_size > 0 else 50000
    if cfg.adaptive:
        cov_mean = 0.0
        ref_cnt = 0
        for i in range(gcbound[0] + 1, gcbound[1]):
            cov_mean += gcbias[i].coverage * gcbias[i].reference
            ref_cnt += gcbias[i].reference
        if ref_cnt:
            cov_mean /= ref_cnt
        if cov_mean <= 0:
            cfg.adaptive = False
            cfg.window_size = 10000
            cfg.window_offset = cfg.window_size
        else:
            read_len = li.rs if li.rs > 0 else cfg.meanisize
            mol_per_bp = (cov_mean / read_len) if cfg.basecov else cov_mean
            if mol_per_bp <= 0:
                mol_per_bp = 1e-9
            win_bp = cfg.target_reads / mol_per_bp
            win_bp = min(max(win_bp, max(100.0, 4.0 * read_len)), 2000000.0)
            cfg.target_exp_cov = cov_mean * win_bp
            eff_win = int(win_bp)
            eff_reads = mol_per_bp * win_bp
            cov_depth = cov_mean if cfg.basecov else cov_mean * read_len
            print(f"Auto window size: {int(win_bp)} bp, {int(eff_reads)} "
                  f"reads/window ("
                  f"{'base-level' if cfg.basecov else 'fragment'}, "
                  f"coverage {cov_depth:.2f}x)", file=sys.stderr)

    regcorr = []
    reg_win = max(50000, eff_win)
    if cfg.regional_gc:
        regcorr = estimate_regional_gc(cfg, bam, fasta, gcbound, gcbias,
                                       scan_counts, reg_win)

    if bam_count(cfg, bam, fasta, li, gcbias, gcbound, regcorr, reg_win):
        stage("Read counting error!")
        return 1
    stage("Done.")
    return 0

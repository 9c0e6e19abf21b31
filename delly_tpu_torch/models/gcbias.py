"""GC bias estimation and regional (replication-wave) correction.

Reference: src/gcbias.h — expected coverage per GC value over the
CN2-stable scan windows, 3-bin curve smoothing, sample/reference
percentile bounds for the correctable GC range, and a 101-bin regional
correction curve over large tiles.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from delly_tpu_torch.io.bam import (
    FDUP, FMUNMAP, FPAIRED, FQCFAIL, FREVERSE, FSECONDARY, FSUPPLEMENTARY,
    FUNMAP,
)
from delly_tpu_torch.models.depth import (
    base_coverage_bulk, gc_content_track, uniq_content_track,
)

from delly_tpu_torch.models.cnv import uniq_threshold
from delly_tpu_torch.utils.log import stage


@dataclass
class GcBias:
    """gcbias.h:24-35 — one entry per GC window sum value."""
    sample: int = 0
    reference: int = 0
    fractionSample: float = 0.0
    fractionReference: float = 0.0
    percentileSample: float = 0.0
    percentileReference: float = 0.0
    obsexp: float = 1.0
    coverage: float = 0.0


def gc_bound(cfg, gcbias: list):
    """Correctable GC range from extreme-percentile exclusion
    (gcbias.h:37-50)."""
    lower = 0
    upper = len(gcbias)
    for i, gb in enumerate(gcbias):
        if (gb.percentileSample < cfg.exclgc
                or gb.percentileReference < cfg.exclgc):
            lower = i
        if (gb.percentileSample + cfg.exclgc > 1
                or gb.percentileReference + cfg.exclgc > 1):
            if i < upper:
                upper = i
    if lower >= upper:
        upper = lower + 1
    return lower, upper


def reg_corr_factor(regcorr: list, gcfrac: float) -> float:
    """gcbias.h:53-61."""
    if not regcorr:
        return 1.0
    b = int(gcfrac * (len(regcorr) - 1) + 0.5)
    b = min(max(b, 0), len(regcorr) - 1)
    return regcorr[b] if regcorr[b] > 0 else 1.0


def smooth_fill_curve(curve: list, weight: list) -> list:
    """Forward/backward hole filling + weighted 3-bin smoothing
    (gcbias.h:64-88)."""
    n = len(curve)
    curve = list(curve)
    if n < 3:
        return curve
    last = 0.0
    have = False
    for i in range(n):
        if weight[i] > 0:
            last = curve[i]
            have = True
        elif have:
            curve[i] = last
    last = 0.0
    have = False
    for i in range(n - 1, -1, -1):
        if weight[i] > 0:
            last = curve[i]
            have = True
        elif have:
            curve[i] = last
    sm = list(curve)
    for i in range(1, n - 1):
        w0 = weight[i - 1] + 1.0
        w1 = 2.0 * (weight[i] + 1.0)
        w2 = weight[i + 1] + 1.0
        sm[i] = (curve[i - 1] * w0 + curve[i] * w1
                 + curve[i + 1] * w2) / (w0 + w1 + w2)
    return sm


def _percentiles(gcbias: list, lo: int, hi: int) -> None:
    """(Re)compute fractions/percentiles over gcbias[lo:hi]
    (gcbias.h:377-426)."""
    total_sample = sum(gb.sample for gb in gcbias[lo:hi])
    total_ref = sum(gb.reference for gb in gcbias[lo:hi])
    cum_sample = 0
    cum_ref = 0
    for gb in gcbias[lo:hi]:
        cum_sample += gb.sample
        cum_ref += gb.reference
        gb.fractionSample = gb.sample / total_sample if total_sample else 0.0
        gb.fractionReference = gb.reference / total_ref if total_ref else 0.0
        gb.percentileSample = cum_sample / total_sample if total_sample else 0.0
        gb.percentileReference = cum_ref / total_ref if total_ref else 0.0
        gb.obsexp = (gb.fractionSample / gb.fractionReference
                     if gb.fractionReference > 0 else 1.0)


def gc_bias(cfg, bam, fasta, scan_counts: list, li, gcbias: list):
    """Expected coverage per GC value (gcbias.h:195-432).
    Returns (gcbound lower, upper)."""
    header = bam.header
    stage("Estimate GC bias")
    from delly_tpu_torch.io.bam import default_decode_workers
    from delly_tpu_torch.parallel import hostaxis
    bam.set_decode_workers(default_decode_workers())
    plan = [ri for ri in range(header.n_targets)
            if scan_counts[ri] and fasta.has_seq(header.names[ri])]
    nproc = hostaxis.process_count()

    def chrom_counts(ref_index):
        """One chromosome's (reference, coverage) per-GC-bin counts
        (gcbias.h:238-360) — the host-axis exchange unit; the serial
        per-bin accumulation replays in chromosome order."""
        reflen = header.lengths[ref_index]
        name = header.names[ref_index]
        seq = fasta.fetch(name)

        bin_of = None
        if cfg.scan_file:
            bin_of = np.full(reflen, -1, dtype=np.int32)
            # LAST_BIN cap, like scan.h:131-137 / gcbias.h:215-219
            for b, w in enumerate(scan_counts[ref_index][:65535]):
                bin_of[w.start:w.end] = b

        gc_content = gc_content_track(seq, cfg.meanisize, key=(cfg.genome, name))

        cov = np.zeros(reflen, dtype=np.uint16)
        cov_uniq = np.zeros(reflen, dtype=np.uint16)
        cov_tot = None if cfg.basecov else np.zeros(reflen, dtype=np.uint16)
        cov_map = cov if cfg.basecov else cov_tot

        # SoA-driven pass (gcbias.h:238-332)
        view = bam.chrom(ref_index)
        flag_a = view["flag"]
        keep = (((flag_a & (FSECONDARY | FQCFAIL | FDUP
                            | FSUPPLEMENTARY | FUNMAP)) == 0)
                & ~(((flag_a & FPAIRED) != 0)
                    & (((flag_a & FMUNMAP) != 0)
                       | (view["mtid"] != ref_index)))
                & (view["mapq"] >= cfg.min_qual))
        sel = np.nonzero(keep)[0]
        offs = view["offsets"][sel]
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
            from delly_tpu_torch.models.genotype_sr import _cigar_stats
            from delly_tpu_torch.models.pairing import (
                first_obs_mask, match_store_pop,
                saturating_midpoint_counts,
            )
            from delly_tpu_torch.utils.hashing import hash_pair_h_batch
            stats = _cigar_stats(view, offs)
            flag_a = view["flag"][sel]
            pos_a = view["pos"][sel]
            mpos_a = view["mpos"][sel]
            nh_a = stats["name_hash"]
            rspan_a = stats["ref_span"]
            paired_a = (flag_a & FPAIRED) != 0
            rev_a = (flag_a & FREVERSE) != 0
            half = cfg.meanisize // 2
            mids = []
            pr = np.nonzero(paired_a)[0]
            if len(pr):
                refs = np.full(len(pr), ref_index, dtype=np.int64)
                p_first = first_obs_mask(pos_a[pr],
                                         pos_a[pr] < mpos_a[pr],
                                         pos_a[pr] == mpos_a[pr],
                                         nh_a[pr])
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
                mids.append(np.where(
                    inb, mpos_a[S] + isize // 2,
                    np.where(rev_a[S], pos_a[S] + rspan_a[S] - half,
                             pos_a[S] + half)))
            up = np.nonzero(~paired_a)[0]
            if len(up):
                mids.append(pos_a[up] + rspan_a[up] // 2)
            if mids:
                cov = saturating_midpoint_counts(
                    np.concatenate(mids), reflen)

        uniq_content = uniq_content_track(cov_map, cov_uniq, seq,
                                          cfg.meanisize)

        # Summarize GC coverage over selected windows (gcbias.h:348-360)
        # float32 product, matching the reference comparison (gcbias.h:350)
        uniq_pos = uniq_content >= uniq_threshold(cfg)
        if bin_of is not None:
            selected = np.zeros(len(scan_counts[ref_index]), dtype=bool)
            for b, w in enumerate(scan_counts[ref_index]):
                selected[b] = w.select
            in_sel = (bin_of >= 0) & selected[np.clip(bin_of, 0, None)]
        else:
            allbins = reflen // cfg.scan_window
            selected = np.zeros(allbins + 1, dtype=bool)
            for b, w in enumerate(scan_counts[ref_index]):
                selected[b] = w.select
            binv = np.arange(reflen) // cfg.scan_window
            in_sel = (binv < allbins) & selected[np.minimum(binv, allbins)]
        mask = uniq_pos & in_sel
        idx = np.nonzero(mask)[0]
        gvals = gc_content[idx].astype(np.int64)
        cvals = cov[idx].astype(np.int64)
        nvals = len(gcbias)
        ref_counts = np.bincount(gvals, minlength=nvals)
        cov_counts = np.bincount(gvals, weights=cvals,
                                 minlength=nvals).astype(np.int64)
        return ref_counts, cov_counts

    if nproc > 1:
        contrib = {ri: chrom_counts(ri)
                   for ri in hostaxis.partition_plan(plan)}
        contrib = hostaxis.exchange_owned(contrib)
    else:
        contrib = None
    for ref_index in plan:
        ref_counts, cov_counts = (contrib[ref_index] if contrib is not None
                                  else chrom_counts(ref_index))
        for i in range(len(gcbias)):
            if ref_counts[i]:
                gcbias[i].reference += int(ref_counts[i])
                gcbias[i].sample += int(cov_counts[i])
                gcbias[i].coverage += float(cov_counts[i])

    # Normalize + smooth
    for gb in gcbias:
        gb.coverage = gb.coverage / gb.reference if gb.reference else 0.0
    cvals = [gb.coverage for gb in gcbias]
    weight = [float(gb.reference) for gb in gcbias]
    cvals = smooth_fill_curve(cvals, weight)
    for gb, v in zip(gcbias, cvals):
        gb.coverage = v

    _percentiles(gcbias, 0, len(gcbias))
    gcbound = gc_bound(cfg, gcbias)
    # Re-normalize within the callable range
    for gb in gcbias:
        gb.fractionSample = 0.0
        gb.fractionReference = 0.0
        gb.percentileSample = 0.0
        gb.percentileReference = 0.0
        gb.obsexp = 1.0
    _percentiles(gcbias, gcbound[0] + 1, gcbound[1])
    return gcbound


def estimate_regional_gc(cfg, bam, fasta, gcbound, gcbias: list,
                         scan_counts: list, reg_win: int) -> list:
    """101-bin regional GC correction curve over large tiles
    (gcbias.h:91-193)."""
    nbin = 101
    regcorr = [1.0] * nbin
    ratios = [[] for _ in range(nbin)]
    header = bam.header
    stage("Estimate regional GC correction")

    sw = cfg.scan_window if cfg.scan_window > 0 else 10000
    grp = max(1, reg_win // sw)
    cov_curve = np.asarray([gb.coverage for gb in gcbias])

    from delly_tpu_torch.parallel import hostaxis
    plan = [ri for ri in range(header.n_targets)
            if scan_counts[ri] and fasta.has_seq(header.names[ri])]
    nproc = hostaxis.process_count()

    def chrom_ratios(ref_index):
        """One chromosome's ordered (bin, ratio) contributions
        (gcbias.h:120-170) — host-axis exchange unit."""
        out = []
        name = header.names[ref_index]
        seq = fasta.fetch(name)
        gc_content = gc_content_track(seq, cfg.meanisize, key=(cfg.genome, name)).astype(np.int64)
        reflen = header.lengths[ref_index]
        in_range = (gc_content > gcbound[0]) & (gc_content < gcbound[1])

        nb = len(scan_counts[ref_index])
        for g0 in range(0, nb, grp):
            g1 = min(nb, g0 + grp)
            observed = float(sum(scan_counts[ref_index][bi].cov
                                 for bi in range(g0, g1)))
            rstart = scan_counts[ref_index][g0].start
            rend = min(scan_counts[ref_index][g1 - 1].end, reflen)
            if rend <= rstart:
                continue
            m = in_range[rstart:rend]
            winlen = int(np.count_nonzero(m))
            total_bases = rend - rstart
            # integer division like the reference (gcbias.h:155-156
            # uses uint32 totalBases / 2)
            if winlen < total_bases // 2 or winlen == 0:
                continue
            gvals = gc_content[rstart:rend][m]
            fine_exp = float(cov_curve[gvals].sum())
            gcnum = float(gvals.sum())
            if fine_exp > 0 and observed > 0:
                obs_valid = observed * (winlen / total_bases)
                gcfrac = (gcnum / winlen) / cfg.meanisize
                b = int(gcfrac * (nbin - 1) + 0.5)
                if 0 <= b < nbin:
                    out.append((b, obs_valid / fine_exp))
        return out

    if nproc > 1:
        contrib = {ri: chrom_ratios(ri)
                   for ri in hostaxis.partition_plan(plan)}
        contrib = hostaxis.exchange_owned(contrib)
    else:
        contrib = None
    for ref_index in plan:
        ents = (contrib[ref_index] if contrib is not None
                else chrom_ratios(ref_index))
        for b, r in ents:
            ratios[b].append(r)

    weight = [0.0] * nbin
    wsum = 0.0
    wtot = 0.0
    for b in range(nbin):
        if len(ratios[b]) >= 10:
            ratios[b].sort()
            med = ratios[b][len(ratios[b]) // 2]
            regcorr[b] = med
            weight[b] = float(len(ratios[b]))
            wsum += med * len(ratios[b])
            wtot += len(ratios[b])
        else:
            regcorr[b] = 0.0
    mean = wsum / wtot if wtot > 0 else 1.0
    if mean > 0:
        for b in range(nbin):
            if weight[b] > 0:
                regcorr[b] /= mean
    regcorr = smooth_fill_curve(regcorr, weight)
    return [r if r > 0 else 1.0 for r in regcorr]

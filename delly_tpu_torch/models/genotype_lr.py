"""Long-read SV genotyping.

Reference: src/genotype.h (genotypeLR). For every primary read spanning an
SV breakpoint, centered REF / ALT / read probe windows are cut and scored
with NW edit distance; the REF-ALT edit-distance delta becomes a
per-read phred-like quality (capped at genoCap). Haplotype (HP/PS) tags
feed phased counts; methylation accumulates per allele.

TPU mapping: the breakpoint probe alignments are collected as jobs during
the host scan and scored with the batched device NW kernel
(ops.edist.batched_edit_distance), bucketed by padded length — the same
device pipeline the short-read genotyper uses. The read-level cap gating
(maxGenoReadCount) depends only on the order candidate reads are seen,
not on alignment outcomes (genotype.h:230-233: the jctMap-size gate can
only fire after the readSV-counter gate), so collect-then-batch is
outcome-equivalent to the reference's streaming loop.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from delly_tpu_torch.io.bam import (
    CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS, CMATCH, CREF_SKIP, CSOFT_CLIP,
    FDUP, FQCFAIL, FSECONDARY, FSUPPLEMENTARY, FUNMAP,
)
from delly_tpu_torch.models.methyl import (
    MethylAccum, accumulate_methyl, build_methyl_calls, finalize_methyl_info,
)
from delly_tpu_torch.models.svanno import annotate_sv
from delly_tpu_torch.ops.edist import MODE_NW, batched_edit_distance
from delly_tpu_torch.utils.tags import is_translocation, revcomp
from delly_tpu_torch.utils.log import stage


def find_seq_bp(rec, pos: int) -> int:
    """Sequence offset of reference position `pos` (genotype.h:59-91)."""
    rp = rec.pos
    sp = 0
    n = rec.n_cigar
    if n == 0:
        return -1
    ops = rec.cigar_ops
    lens = rec.cigar_lens
    for i in range(n):
        op = ops[i]
        ol = int(lens[i])
        if op in (CMATCH, CEQUAL, CDIFF):
            # per-base check happens before the advance (genotype.h:69-70),
            # so pos == rp + ol falls through to the next op
            if pos < rp + ol:
                return sp + max(0, pos - rp)
            rp += ol
            sp += ol
        elif op == CDEL:
            rp += ol
            if rp >= pos:
                return sp
        elif op == CINS:
            sp += ol
        elif op == CREF_SKIP:
            rp += ol
            if rp >= pos:
                return sp
        elif op in (CSOFT_CLIP, CHARD_CLIP):
            sp += ol
    if ops[n - 1] in (CSOFT_CLIP, CHARD_CLIP):
        return sp - int(lens[n - 1])
    return -1


@dataclass
class _Job:
    """One read x SV genotyping unit (>=1 breakpoint alignments)."""
    file_c: int
    svid: int
    rec_idx: int
    pairs: list  # [(ref_probe, alt_probe, probe, probe_for_alt), ...]
    candidates: list  # breakpoint positions the read overlaps
    ref_index: int = -1   # chromosome of the read (methylation window)
    chrom_len: int = 0
    # host-axis translocation tape entry: when set, the flush records
    # the pair scores into it instead of tallying (the tra job replays
    # serially on every process after the exchange)
    tape: dict | None = None


def _rec_blob(view, off: int) -> bytes:
    """Raw BAM record bytes (block_size prefix + record) at a view
    offset — the host-axis shipping unit for translocation genotyping
    attempts (replayed with io.bam.parse_record_at(blob, 0))."""
    import struct
    (block_size,) = struct.unpack_from("<i", view.data, off)
    return bytes(view.data[off:off + 4 + block_size])


def _probe_rc_needed(svt: int, pos: int, sv) -> bool:
    """Whether the read probe is reverse-complemented for the ALT
    alignment (genotype.h:277-283)."""
    return ((svt == 0 and pos == sv.svEnd)
            or (svt == 1 and pos == sv.svStart)
            or (svt == 5 and pos == sv.svEnd)
            or (svt == 6 and pos == sv.svStart))


def _score_jobs(jobs: list, flank_quality: float):
    """Batched NW edit distances for all job pairs, bucketed by length."""
    flat = []  # (job_idx, pair_idx, which, query, target)
    for ji, job in enumerate(jobs):
        for pi, (ref_p, alt_p, probe, probe_rc) in enumerate(job.pairs):
            flat.append((ji, pi, 0, ref_p, probe))
            flat.append((ji, pi, 1, alt_p, probe_rc))
    results = {}
    if not flat:
        return results
    # bucket by padded shape to bound compile count
    def bucket(n):
        b = 64
        while b < n:
            b *= 2
        return b

    buckets = {}
    for item in flat:
        key = (bucket(len(item[3])), bucket(len(item[4])))
        buckets.setdefault(key, []).append(item)
    # two-phase: ISSUE every bucket's batch first (device dispatches
    # are async — H2D and kernels for later buckets overlap earlier
    # ones on remote links), THEN pull. A per-bucket synchronous pull
    # serializes one full round trip per bucket.
    pending = []
    for (m, n), items in buckets.items():
        B = len(items)
        q = np.zeros((B, m), dtype=np.uint8)
        t = np.zeros((B, n), dtype=np.uint8)
        ql = np.zeros(B, dtype=np.int32)
        tl = np.zeros(B, dtype=np.int32)
        for i, (_, _, _, qs, ts) in enumerate(items):
            qb = qs.encode()
            tb = ts.encode()
            q[i, :len(qb)] = np.frombuffer(qb, dtype=np.uint8)
            t[i, :len(tb)] = np.frombuffer(tb, dtype=np.uint8)
            ql[i] = len(qb)
            tl[i] = len(tb)
        pending.append((items,
                        batched_edit_distance(q, ql, t, tl, MODE_NW)))
    for items, out in pending:
        dists = np.asarray(out)
        for i, (ji, pi, which, qs, _) in enumerate(items):
            results[(ji, pi, which)] = (int(dists[i]), len(qs))
    return results


def genotype_lr(cfg, bams, fasta, svs: list, jct_map, rc_map, methyl_map):
    """genotype.h:93-397. Mutates jctMap/rcMap/methylMap in place and
    annotates SVs (alleles + MEI/TR) on the fly."""
    if not svs:
        return
    from delly_tpu_torch.parallel import hostaxis

    header = bams[0].header
    n_files = len(bams)
    read_sv = [dict() for _ in range(n_files)]  # svid -> candidate count
    methyl_accum = [
        {sv.id: MethylAccum() for sv in svs} for _ in range(n_files)]
    dump_rows = []

    # Host-axis mode (genotype.h:93-397 sharded by chromosome):
    # non-translocation SVs are chromosome-complete, so their tallies
    # finish locally on the owner and ship as finished per-SV products;
    # translocation attempts span two chromosomes and ship as ordered
    # tape entries (scores + raw record blob) that every process
    # replays serially, reproducing the read-cap and parity order.
    nproc = hostaxis.process_count()
    hx = nproc > 1 and not cfg.dumpfile
    tra_tape: dict = {}  # (ref_index, file_c) -> ordered entries

    stage("SV annotation")
    w = math.log10(cfg.flank_quality / (1.0 - cfg.flank_quality))

    # Probe-alignment jobs accumulate across chromosomes (each job
    # carries its chromosome/file) and flush as large device batches:
    # per-chromosome dispatches pay one round trip each on remote
    # devices. The tally runs in global job order, so the per-SV
    # read-cap semantics are unchanged.
    jobs: list = []
    job_recs: list = []
    npairs = 0
    ncells = 0
    # big-DP LR batches are dispatch-latency-bound on remote links:
    # accumulate until the flush is worth a round trip (pair count for
    # the small-probe regime, cell volume for the multi-megacell one)
    flush_cells = int(os.environ.get("DELLY_TPU_LR_FLUSH_CELLS",
                                     str(8 << 30)))

    def _flush_lr_jobs(force: bool = False) -> None:
        nonlocal npairs, ncells
        if not jobs or (not force and npairs < 16384
                        and len(job_recs) < 16384
                        and ncells < flush_cells):
            return
        results = _score_jobs(jobs, cfg.flank_quality)
        meth_cache = {}
        for ji, job in enumerate(jobs):
            if job.tape is not None:
                # host-axis tra job: record scores for the serial
                # replay; no local tally
                job.tape["scores"] = [
                    (results[(ji, pi, 0)][0], results[(ji, pi, 1)][0],
                     len(p[0]), len(p[1]))
                    for pi, p in enumerate(job.pairs)]
                continue
            sv = svs[job.svid]
            rec, sequence = job_recs[job.rec_idx]
            jct = jct_map[job.file_c][job.svid]
            if (len(jct.ref) + len(jct.alt)) >= cfg.max_geno_read_count:
                continue
            refedsum = 0
            altedsum = 0
            n_inform = 0
            for pi, (ref_p, alt_p, _probe, _probe_rc) in enumerate(
                    job.pairs):
                ref_score, _rl = results[(ji, pi, 0)]
                alt_score, _al = results[(ji, pi, 1)]
                score_a = ((1.0 - cfg.flank_quality) * len(alt_p)
                           / (alt_score + 1))
                score_r = ((1.0 - cfg.flank_quality) * len(ref_p)
                           / (ref_score + 1))
                if score_r > 0.6 or score_a > 0.6:
                    refedsum += ref_score
                    altedsum += alt_score
                    n_inform += 1
            if n_inform == 0:
                continue
            delta = refedsum - altedsum
            ex = min(abs(delta) * w, 4.0)
            mq = int(10.0 * math.log10(1.0 + math.pow(10.0, ex)))
            qual = min(mq, cfg.geno_cap)

            hp = 0
            ps = -1
            hp_tag = rec.aux("HP")
            if hp_tag is not None:
                hp = int(hp_tag) & 0xFF   # (uint8_t) cast, genotype.h:220
            ps_tag = rec.aux("PS")
            if ps_tag is not None:
                ps = int(ps_tag)

            key = id(rec)
            if key not in meth_cache:
                meth_cache[key] = build_methyl_calls(rec, cfg.methyl_prob)
            has_methyl, calls = meth_cache[key]
            cands = job.candidates

            if delta <= 0:
                if has_methyl:
                    accumulate_methyl(
                        cfg, rec, calls, sv, job.ref_index,
                        job.chrom_len, False, cands,
                        methyl_accum[job.file_c][job.svid],
                        sequence or "")
                jct.ref.append(qual)
                if hp == 1:
                    jct.hp1ref.append(qual)
                elif hp == 2:
                    jct.hp2ref.append(qual)
            else:
                if has_methyl:
                    accumulate_methyl(
                        cfg, rec, calls, sv, job.ref_index,
                        job.chrom_len, True, cands,
                        methyl_accum[job.file_c][job.svid],
                        sequence or "")
                if cfg.dumpfile:
                    dump_rows.append((job.svid, sv.svt,
                                      cfg.files[job.file_c], rec.qname,
                                      header.names[rec.tid], rec.pos,
                                      rec.mapq))
                jct.alt.append(qual)
                if hp == 1:
                    jct.hp1alt.append(qual)
                elif hp == 2:
                    jct.hp2alt.append(qual)
                if hp > 0 and ps >= 0 and jct.ps < 0:
                    jct.ps = ps
        jobs.clear()
        job_recs.clear()
        npairs = 0
        ncells = 0

    sv_chrs = sorted({c for sv in svs for c in (sv.chr, sv.chr2)})
    plan_all = [ri for ri in sv_chrs if 0 <= ri < header.n_targets]
    plan_mine = hostaxis.partition_plan(plan_all) if hx else plan_all
    for bam in bams:
        bam.set_decode_workers(getattr(cfg, "max_threads", 1) or 1,
                               plan_mine)
    for ref_index in plan_mine:
        bp_map = []  # (pos, svid)
        for sv in svs:
            if sv.chr == ref_index:
                bp_map.append((sv.svStart, sv.id))
            if sv.chr2 == ref_index:
                bp_map.append((sv.svEnd, sv.id))
        if not bp_map:
            continue
        bp_map.sort()
        bp_pos = np.asarray([b[0] for b in bp_map], dtype=np.int64)
        chrom_len = header.lengths[ref_index]
        seq = fasta.fetch(header.names[ref_index]).upper()

        # Symbolic ALT alleles + MEI/TR annotation (genotype.h:155-163)
        for sv in svs:
            if sv.chr == ref_index and not sv.alleles:
                from delly_tpu_torch.models.genotype_sr import _add_alleles
                sv.alleles = _add_alleles(
                    seq[sv.svStart - 1:sv.svStart],
                    header.names[sv.chr2], sv)
            if sv.chr == ref_index and not is_translocation(sv.svt):
                annotate_sv(cfg, header.lengths, seq, sv)

        for file_c in range(n_files):
            # SoA-driven pass (genotype.h:196-214): coverage from the
            # native diff-array walk; records parsed only when the
            # clipped read window overlaps an SV breakpoint.
            bam = bams[file_c]
            ch_tra: list = []
            if hx:
                tra_tape[(ref_index, file_c)] = ch_tra
            view = bam.chrom(ref_index)
            flag_a = view["flag"]
            keep = (((flag_a & (FSECONDARY | FQCFAIL | FDUP | FUNMAP))
                     == 0)
                    & (view["mapq"] >= cfg.min_map_qual))
            sel = np.nonzero(keep)[0]
            offs = view["offsets"][sel]
            from delly_tpu_torch.models.genotype_sr import _match_coverage
            cov_bases = _match_coverage(view, offs, chrom_len)
            # per-base uint16 saturation (genotype.h:188
            # covBases[rp] < maxCoverage - 1)
            np.minimum(cov_bases, 65534, out=cov_bases)
            cov_bases = cov_bases.astype(np.int32)
            from delly_tpu_torch.models.genotype_sr import _cigar_stats
            stats = _cigar_stats(view, offs)
            flag_a = view["flag"][sel]
            pos_a = view["pos"][sel]
            prim = (((flag_a & FSUPPLEMENTARY) == 0)
                    & (view["lqseq"][sel] >= 2 * cfg.min_flank_size))
            rs = np.maximum(pos_a - stats["lead_clip"], 0) \
                + cfg.min_flank_size
            re_ = pos_a + stats["ref_span"] + stats["trail_clip"]
            cand = prim & (re_ > cfg.min_flank_size)
            re_c = re_ - cfg.min_flank_size
            cand &= rs < re_c
            lo_a = np.searchsorted(bp_pos, rs, side="left")
            hi_a = np.searchsorted(bp_pos, re_c, side="right")
            cand &= lo_a < hi_a
            # scalarize only the candidate subset (full-column tolist
            # is O(reads) Python objects)
            cand_rows = np.nonzero(cand)[0]
            offs_l = dict(zip(cand_rows.tolist(),
                              offs[cand_rows].tolist()))
            for i in cand_rows.tolist():
                rec = view.parse_at(offs_l[i])
                r_start = int(rs[i])
                r_end = int(re_c[i])
                lo = int(lo_a[i])
                hi = int(hi_a[i])
                process = sorted({bp_map[k][1] for k in range(lo, hi)})

                sequence = None
                for svid in process:
                    sv = svs[svid]
                    tra_hx = hx and is_translocation(sv.svt)
                    if tra_hx:
                        # attempt tape entry: counts toward the
                        # replayed read cap even without a job
                        entry = {"svid": svid, "scores": None}
                        ch_tra.append(entry)
                    else:
                        cnt = read_sv[file_c].get(svid, 0)
                        if cnt >= cfg.max_geno_read_count:
                            continue
                        read_sv[file_c][svid] = cnt + 1

                    candidates = []
                    if (sv.chr == ref_index and r_start <= sv.svStart
                            <= r_end):
                        candidates.append(sv.svStart)
                    if (sv.chr2 == ref_index and r_start <= sv.svEnd
                            <= r_end):
                        candidates.append(sv.svEnd)
                    if not candidates:
                        continue

                    pairs = []
                    for pos in candidates:
                        sp_bp = find_seq_bp(rec, pos)
                        if sp_bp < 0:
                            continue
                        cons_bp = sv.consBp
                        if pos == sv.svEnd:
                            cons_bp += sv.insLen
                        r_start_off = pos - max(0, pos - sp_bp)
                        r_end_off = min(pos + rec.l_qseq - sp_bp,
                                        chrom_len) - pos
                        c_start_off = cons_bp - max(0, cons_bp - sp_bp)
                        c_end_off = min(cons_bp + rec.l_qseq - sp_bp,
                                        len(sv.consensus)) - cons_bp
                        offset = min(r_start_off, c_start_off, r_end_off,
                                     c_end_off)
                        if offset < cfg.min_flank_size:
                            continue
                        if (not is_translocation(sv.svt)
                                and 2 * offset < cfg.min_cons_window):
                            continue
                        if sequence is None:
                            sequence = rec.seq
                        ref_p = seq[pos - offset:pos + offset]
                        alt_p = sv.consensus[cons_bp - offset:
                                             cons_bp + offset]
                        probe = sequence[sp_bp - offset:sp_bp + offset]
                        probe_alt = (revcomp(probe)
                                     if _probe_rc_needed(sv.svt, pos, sv)
                                     else probe)
                        pairs.append((ref_p, alt_p, probe, probe_alt))
                    if pairs:
                        if tra_hx:
                            entry["blob"] = _rec_blob(view, offs_l[i])
                            entry["candidates"] = candidates
                        jobs.append(_Job(file_c, svid, len(job_recs),
                                         pairs, candidates, ref_index,
                                         chrom_len,
                                         entry if tra_hx else None))
                        job_recs.append((rec, sequence))
                        npairs += len(pairs)
                        ncells += sum(
                            len(rp) * len(pb)
                            + len(ap) * len(pa)
                            for rp, ap, pb, pa in pairs)

            # Device-batched NW scoring + sequential tally, deferred
            # until the accumulated batch is large enough
            _flush_lr_jobs()

            # Coverage annotation (genotype.h:344-378)
            for sv in svs:
                if sv.chr != ref_index:
                    continue
                half = (sv.svEnd - sv.svStart) // 2
                if is_translocation(sv.svt) or sv.svt == 4:
                    half = 500
                lstart = max(sv.svStart - half, 0)
                rc = rc_map[file_c][sv.id]
                rc.leftRC = int(cov_bases[lstart:sv.svStart].sum())
                mstart, mend = sv.svStart, sv.svEnd
                if is_translocation(sv.svt) or sv.svt == 4:
                    mstart = max(sv.svStart - half, 0)
                    mend = min(sv.svStart + half, chrom_len)
                rc.rc = int(cov_bases[mstart:mend].sum())
                rstart, rend = sv.svEnd, min(sv.svEnd + half, chrom_len)
                if is_translocation(sv.svt) or sv.svt == 4:
                    rstart = sv.svStart
                    rend = min(sv.svStart + half, chrom_len)
                rc.rightRC = int(cov_bases[rstart:rend].sum())

    _flush_lr_jobs(force=True)

    if hx:
        # Exchange finished per-SV products (owner-complete for
        # non-translocation SVs) and replay the translocation tape
        # serially on every process.
        owned_set = set(plan_mine)
        prod = {"sv": {}, "jct": {}, "meth": {}, "rc": {},
                "tra": tra_tape}
        for sv in svs:
            if sv.chr not in owned_set:
                continue
            prod["sv"][sv.id] = sv
            for f in range(n_files):
                prod["rc"][(f, sv.id)] = rc_map[f][sv.id]
            if not is_translocation(sv.svt):
                for f in range(n_files):
                    prod["jct"][(f, sv.id)] = jct_map[f][sv.id]
                    prod["meth"][(f, sv.id)] = methyl_accum[f][sv.id]
        parts = hostaxis.allgather_obj(prod)
        for part in parts:
            for svid, sv in part["sv"].items():
                svs[svid] = sv
            for (f, svid), jc in part["jct"].items():
                jct_map[f][svid] = jc
            for (f, svid), ma in part["meth"].items():
                methyl_accum[f][svid] = ma
            for (f, svid), rcv in part["rc"].items():
                rc_map[f][svid] = rcv
        merged_tra: dict = {}
        for part in parts:
            for key, entries in part["tra"].items():
                merged_tra.setdefault(key, entries)

        from delly_tpu_torch.io.bam import parse_record_at
        read_sv_tra = [dict() for _ in range(n_files)]
        for ref_index in plan_all:
            chrom_len = header.lengths[ref_index]
            for file_c in range(n_files):
                for entry in merged_tra.get((ref_index, file_c), ()):
                    svid = entry["svid"]
                    cnt = read_sv_tra[file_c].get(svid, 0)
                    if cnt >= cfg.max_geno_read_count:
                        continue
                    read_sv_tra[file_c][svid] = cnt + 1
                    scores = entry.get("scores")
                    if not scores:
                        continue
                    jct = jct_map[file_c][svid]
                    if (len(jct.ref) + len(jct.alt)) \
                            >= cfg.max_geno_read_count:
                        continue
                    refedsum = 0
                    altedsum = 0
                    n_inform = 0
                    for ref_score, alt_score, l_ref, l_alt in scores:
                        score_a = ((1.0 - cfg.flank_quality) * l_alt
                                   / (alt_score + 1))
                        score_r = ((1.0 - cfg.flank_quality) * l_ref
                                   / (ref_score + 1))
                        if score_r > 0.6 or score_a > 0.6:
                            refedsum += ref_score
                            altedsum += alt_score
                            n_inform += 1
                    if n_inform == 0:
                        continue
                    delta = refedsum - altedsum
                    ex = min(abs(delta) * w, 4.0)
                    mq = int(10.0 * math.log10(1.0 + math.pow(10.0, ex)))
                    qual = min(mq, cfg.geno_cap)
                    rec = parse_record_at(entry["blob"], 0)
                    hp = 0
                    ps = -1
                    hp_tag = rec.aux("HP")
                    if hp_tag is not None:
                        hp = int(hp_tag) & 0xFF
                    ps_tag = rec.aux("PS")
                    if ps_tag is not None:
                        ps = int(ps_tag)
                    has_methyl, calls = build_methyl_calls(
                        rec, cfg.methyl_prob)
                    sv = svs[svid]
                    sequence = rec.seq
                    is_alt = delta > 0
                    if has_methyl:
                        accumulate_methyl(
                            cfg, rec, calls, sv, ref_index, chrom_len,
                            is_alt, entry["candidates"],
                            methyl_accum[file_c][svid], sequence or "")
                    if not is_alt:
                        jct.ref.append(qual)
                        if hp == 1:
                            jct.hp1ref.append(qual)
                        elif hp == 2:
                            jct.hp2ref.append(qual)
                    else:
                        jct.alt.append(qual)
                        if hp == 1:
                            jct.hp1alt.append(qual)
                        elif hp == 2:
                            jct.hp2alt.append(qual)
                        if hp > 0 and ps >= 0 and jct.ps < 0:
                            jct.ps = ps

    # Finalize methylation summaries
    for file_c in range(n_files):
        for sv in svs:
            methyl_map[file_c][sv.id] = finalize_methyl_info(
                methyl_accum[file_c][sv.id], cfg.min_cpg_depth)

    # SV-supporting read dump (genotype.h:127-133,325-331)
    if cfg.dumpfile:
        import gzip

        from delly_tpu_torch.utils.tags import add_id
        with gzip.open(cfg.dumpfile, "wt") as fh:
            fh.write("#svid\tbam\tqname\tchr\tpos\tmapq\ttype\n")
            for svid, svt, bam, qname, chrom, pos, mapq in dump_rows:
                fh.write(f"{add_id(svt)}{svid:08d}\t{bam}\t{qname}\t"
                         f"{chrom}\t{pos}\t{mapq}\tSR\n")

"""Synthetic BAM/FASTA datasets for runs of the PyTorch port.

A copy of eight generators of the repository's test BAM writer
(tests/bamsynth.py) and their helpers, bound to this package's io and
utils, so that a run on the card (chip_smoke.py) can build the
datasets without importing the JAX package; the first five return
(bam, fasta, truth):

- ``make_multi_sv_dataset``: every contig carries a het DEL, a tandem
  DUP, an INV and a novel INS, and contig pairs a BND, under uniform
  background pairs;
- ``make_deep_geno_dataset``: many het DELs under deep coverage, the
  genotyping regime;
- ``make_lr_sv_dataset``: long reads with the five SV families (CIGAR
  DEL and INS, split-alignment DUP, INV and BND);
- ``make_lr_genome_dataset``: a DEL and an INS per contig under long
  background reads, optionally with ONT-like substitution and 1 bp indel
  noise (``noisy_segment``);
- ``make_deep_lr_dataset``: many het ~1 kb DELs under deep long-read
  coverage, the long-read genotyping regime;
- ``make_multi_contig_del_dataset``: a het ~8 kb DEL per contig and a
  homozygous read-depth hole (the ``cnv`` regime);
- ``make_population_cohort``: one BAM per sample of a cohort carrying
  het DELs at drawn allele frequencies (``merge`` and ``filter -f
  germline``); returns (bams, fasta, truth);
- ``make_somatic_pair_dataset``: a tumor and a control BAM with
  germline and tumor-only DELs (``filter -f somatic``); returns (tumor,
  control, fasta, germline truth, somatic truth).

Same seed and arguments give the same bytes as tests/bamsynth.py. The
three ``asm`` datasets are the constructions of bench_e2e.py's assembly
run and of tests/test_asm.py, as functions:

- ``make_asm_indel_dataset``: a DEL and an INS as CIGAR indels in two
  contig-length alignments (squashed mode);
- ``make_asm_diploid_dataset``: a homozygous DEL and a hap1-only INS in
  two haplotype BAMs (``-y diploid``);
- ``make_asm_split_dataset``: DUP, INV and BND as split contig
  alignments, over two samples.

One generator is the port's own, with no counterpart there:

- ``make_long_split_dataset``: het DELs seen through split reads longer
  than 8,192 bases, the regime of the corridor MSA merge (K3/K3-tb).
"""

import random
import struct

import numpy as np

from delly_tpu_torch.io.bgzf import bgzf_compress
from delly_tpu_torch.utils.tags import revcomp

_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_NT16_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in _NT16.items():
    _NT16_LUT[ord(_c)] = _i


def _pack_seq(seq: str) -> bytes:
    """4-bit pack a base string (vectorized; generation hot path)."""
    codes = _NT16_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if len(codes) % 2:
        codes = np.concatenate([codes, np.zeros(1, dtype=np.uint8)])
    return ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()


def encode_record(qname, flag, tid, pos, mapq, cigar, mtid, mpos, tlen,
                  seq, qual=None, aux=b""):
    """cigar: list of (op_char, length). aux: raw BAM aux bytes."""
    name = qname.encode() + b"\x00"
    cig = b"".join(struct.pack("<I", (n << 4) | "MIDNSHP=X".index(op))
                   for op, n in cigar)
    nseq = len(seq)
    q = bytes([30] * nseq) if qual is None else qual
    body = struct.pack("<iiBBHHHiiii", tid, pos, len(name), mapq, 0,
                       len(cigar), flag, nseq, mtid, mpos, tlen)
    body += name + cig + _pack_seq(seq) + q + aux
    return struct.pack("<i", len(body)) + body


def random_contig(rng_or_seed, length: int, gc_blocks: int = 0) -> str:
    """Fast random ACGT contig (numpy; scales to Mbp). With
    `gc_blocks` > 0, the contig gets block-wise GC-content variation
    (0.35–0.60) so GC-percentile machinery (delly cnv) has a real
    distribution to work with."""
    seed = (rng_or_seed if isinstance(rng_or_seed, int)
            else rng_or_seed.randint(0, 2**31))
    g = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    if not gc_blocks:
        return letters[g.integers(0, 4, size=length)].tobytes().decode()
    block = max(1, length // gc_blocks)
    out = np.empty(length, dtype=np.uint8)
    pos = 0
    while pos < length:
        n = min(block, length - pos)
        gc = g.uniform(0.35, 0.60)
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        out[pos:pos + n] = letters[g.choice(4, size=n, p=p)]
        pos += n
    return out.tobytes().decode()


def write_bam(path, contigs, records, index=True, sample="synth"):
    """contigs: list of (name, seq). records: encoded record blobs in
    coordinate order. Writes a .bai alongside (like samtools index) so
    the streaming reader can region-query the file."""
    text = "".join(f"@SQ\tSN:{n}\tLN:{len(s)}\n" for n, s in contigs)
    text += f"@RG\tID:{sample}\tSM:{sample}\n"
    out = bytearray()
    out += b"BAM\x01" + struct.pack("<i", len(text))
    out += text.encode()
    out += struct.pack("<i", len(contigs))
    for n, s in contigs:
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", len(s))
    for rec in records:
        out += rec
    comp = bgzf_compress(bytes(out))
    with open(path, "wb") as fh:
        fh.write(comp)
    if index:
        from delly_tpu_torch.io.bai import build_bai
        with open(path + ".bai", "wb") as fh:
            fh.write(build_bai(comp))


def write_fasta(path, contigs):
    with open(path, "w") as fh:
        for n, s in contigs:
            fh.write(f">{n}\n")
            for k in range(0, len(s), 60):
                fh.write(s[k:k + 60] + "\n")
    with open(path + ".fai", "w") as fh:
        off = 0
        for n, s in contigs:
            off += len(n) + 2
            nlines = (len(s) + 59) // 60
            fh.write(f"{n}\t{len(s)}\t{off}\t60\t61\n")
            off += len(s) + nlines


def add_read_errors(rng_or_seed, seq: str, rate: float) -> str:
    """Substitution errors at `rate` (uniform; keeps CIGAR geometry so
    implanted-SV truth coordinates stay exact while consensus/realign
    stages see realistic noise)."""
    if rate <= 0:
        return seq
    seed = (rng_or_seed if isinstance(rng_or_seed, int)
            else rng_or_seed.randint(0, 2**31))
    g = np.random.default_rng(seed)
    b = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
    hit = np.flatnonzero(g.random(len(b)) < rate)
    if len(hit):
        letters = np.frombuffer(b"ACGT", dtype=np.uint8)
        # shift by 1-3 letters so the substitution always changes the base
        codes = np.searchsorted(letters, b[hit]) % 4
        b[hit] = letters[(codes + g.integers(1, 4, len(hit))) % 4]
    return b.tobytes().decode()


def noisy_segment(g, ref_seq: str, sub_rate: float,
                  indel_rate: float):
    """One aligned segment with substitution + 1bp indel noise.
    Consumes exactly len(ref_seq) reference bases; returns
    (cigar_ops, read_seq) where cigar_ops is a list of (op, len) with
    op in M/I/D (how a real aligner would represent the noisy read)."""
    if sub_rate <= 0 and indel_rate <= 0:
        return [("M", len(ref_seq))], ref_seq
    letters = "ACGT"
    b = np.frombuffer(ref_seq.encode(), dtype=np.uint8).copy()
    L = len(b)
    r = g.random(L)
    # substitutions
    sub_hit = np.flatnonzero(r < sub_rate)
    if len(sub_hit):
        let = np.frombuffer(b"ACGT", dtype=np.uint8)
        codes = np.searchsorted(let, b[sub_hit]) % 4
        b[sub_hit] = let[(codes + g.integers(1, 4, len(sub_hit))) % 4]
    # indels: positions (interior only), half insertions half deletions
    ind = np.flatnonzero((r >= sub_rate)
                         & (r < sub_rate + indel_rate))
    ind = ind[(ind > 0) & (ind < L - 1)]
    is_ins = g.random(len(ind)) < 0.5
    ops = []
    seq = []
    prev = 0
    for pos, insv in zip(ind.tolist(), is_ins.tolist()):
        mlen = pos - prev
        if mlen > 0:
            ops.append(("M", mlen))
            seq.append(b[prev:pos].tobytes().decode())
        if insv:
            ops.append(("M", 1))
            seq.append(b[pos:pos + 1].tobytes().decode())
            ops.append(("I", 1))
            seq.append(letters[int(g.integers(0, 4))])
            prev = pos + 1
        else:
            ops.append(("D", 1))
            prev = pos + 1
    if prev < L:
        ops.append(("M", L - prev))
        seq.append(b[prev:].tobytes().decode())
    # merge adjacent same-op runs
    merged = []
    for op, ln in ops:
        if merged and merged[-1][0] == op:
            merged[-1][1] += ln
        else:
            merged.append([op, ln])
    return [(op, ln) for op, ln in merged], "".join(seq)


def make_multi_sv_dataset(tmpdir, n_contigs=4, contig_len=400_000,
                          pairs_per_contig=6000, sr_per_sv=10,
                          pe_per_sv=14, seed=97, name="svmix",
                          error_rate=0.0):
    """Genome-scale mixed-SV truth set: every contig carries a het
    ~8kb DEL (PE+SR), a ~3kb tandem DUP (PE+SR), a ~4kb INV (PE, 3to3
    -> IMPRECISE like the reference's PE-only inversions), and a 40bp
    novel INS (SR); every even/odd contig pair carries one 3to5 BND
    junction (PE+SR). Returns (bam, fasta, truth) with truth a list of
    (type, chrom, pos[, chrom2/pos2/end]) tuples."""
    rng = random.Random(seed)
    contigs = [(f"chr{c + 1}",
                random_contig(rng, contig_len,
                              gc_blocks=max(1, contig_len // 10_000)))
               for c in range(n_contigs)]
    rl, isize = 100, 400
    recs = []          # evidence records (tid, pos, blob)
    bulk = []          # per-contig (pos, buf, rec_w) bulk pair buffers
    truth = []
    qid = 0

    def err(seq):
        return add_read_errors(rng, seq, error_rate)

    def rec(tid, pos, *args):
        recs.append((tid, pos, encode_record(*args)))

    for tid, (cname, ref) in enumerate(contigs):
        del_bp1 = contig_len * 15 // 100
        del_bp2 = del_bp1 + 8000
        dup_bp1 = contig_len * 35 // 100
        dup_bp2 = dup_bp1 + 3000
        inv_bp1 = contig_len * 55 // 100
        inv_bp2 = inv_bp1 + 4000
        ins_bp = contig_len * 75 // 100
        ins_seq = "".join(rng.choice("ACGT") for _ in range(40))
        truth += [("DEL", cname, del_bp1, del_bp2),
                  ("DUP", cname, dup_bp1, dup_bp2),
                  ("INV", cname, inv_bp1, inv_bp2),
                  ("INS", cname, ins_bp, ins_bp)]

        # background pairs for library statistics (bulk-vectorized)
        g = np.random.default_rng(rng.randint(0, 2**31))
        isz = isize + g.integers(-60, 61, size=pairs_per_contig)
        bp1s = g.integers(0, contig_len - isz.max() - 1,
                          size=pairs_per_contig)
        ref_u8 = np.frombuffer(ref.encode(), dtype=np.uint8)
        bulk.append(_bulk_pair_records(
            tid, ref_u8, bp1s, isz, qid, rl=rl, error_rate=error_rate,
            seed=rng.randint(0, 2**31)))
        qid += pairs_per_contig

        # DEL: discordant spanning pairs + split reads
        del_hap = ref[:del_bp1] + ref[del_bp2:]
        for _ in range(pe_per_sv):
            off = rng.randint(30, 200)
            p1 = del_bp1 - off - rl
            p2 = del_bp2 + (isize - off - 2 * rl) + rng.randint(0, 40)
            tl = p2 + rl - p1
            rec(tid, p1, f"d{qid}", 0x61, tid, p1, 60, [("M", rl)],
                tid, p2, tl, err(ref[p1:p1 + rl]))
            rec(tid, p2, f"d{qid}", 0x91, tid, p2, 60, [("M", rl)],
                tid, p1, -tl, err(ref[p2:p2 + rl]))
            qid += 1
        for _ in range(sr_per_sv):
            off = rng.randint(30, 70)
            dpos = del_bp1 - off
            seq = err(del_hap[dpos:dpos + rl])
            rec(tid, dpos, f"s{qid}", 0x0, tid, dpos, 60,
                [("M", off), ("S", rl - off)], -1, -1, 0, seq)
            rec(tid, del_bp2, f"s{qid}", 0x800, tid, del_bp2, 60,
                [("S", off), ("M", rl - off)], -1, -1, 0, seq)
            qid += 1

        # DUP: RF discordant pairs over the copy junction + split reads
        # (junction maps the unit end back to the unit start)
        for _ in range(pe_per_sv):
            o1 = rng.randint(20, 120)
            o2 = rng.randint(20, 120)
            pf = dup_bp2 - o1 - rl
            pr = dup_bp1 + o2
            rec(tid, pf, f"u{qid}", 0x61, tid, pf, 60, [("M", rl)],
                tid, pr, 0, err(ref[pf:pf + rl]))
            rec(tid, pr, f"u{qid}", 0x91, tid, pr, 60, [("M", rl)],
                tid, pf, 0, err(ref[pr:pr + rl]))
            qid += 1
        for _ in range(sr_per_sv):
            off = rng.randint(30, 70)
            dpos = dup_bp2 - off
            seq = err(ref[dpos:dup_bp2] + ref[dup_bp1:dup_bp1 + rl - off])
            rec(tid, dpos, f"w{qid}", 0x0, tid, dpos, 60,
                [("M", off), ("S", rl - off)], -1, -1, 0, seq)
            rec(tid, dup_bp1, f"w{qid}", 0x800, tid, dup_bp1, 60,
                [("S", off), ("M", rl - off)], -1, -1, 0, seq)
            qid += 1

        # INV: 3to3 FF pairs (PE-only, IMPRECISE)
        for _ in range(2 * pe_per_sv):
            o1 = rng.randint(20, 120)
            o2 = rng.randint(20, 120)
            p1 = inv_bp1 - o1 - rl
            p2 = inv_bp2 - o2 - rl
            rec(tid, p1, f"v{qid}", 0x41, tid, p1, 60, [("M", rl)],
                tid, p2, 0, err(ref[p1:p1 + rl]))
            rec(tid, p2, f"v{qid}", 0x81, tid, p2, 60, [("M", rl)],
                tid, p1, 0, err(ref[p2:p2 + rl]))
            qid += 1

        # INS: split reads spanning the novel 40bp insertion
        ins_hap = ref[:ins_bp] + ins_seq + ref[ins_bp:]
        for _ in range(sr_per_sv):
            off = rng.randint(26, 34)
            dpos = ins_bp - off
            seq = err(ins_hap[dpos:dpos + rl])
            m2 = rl - off - len(ins_seq)
            rec(tid, dpos, f"i{qid}", 0x0, tid, dpos, 60,
                [("M", off), ("S", rl - off)], -1, -1, 0, seq)
            rec(tid, ins_bp, f"i{qid}", 0x800, tid, ins_bp, 60,
                [("S", rl - m2), ("M", m2)], -1, -1, 0, seq)
            qid += 1

    # BND: one 3to5 junction per even/odd contig pair
    for ta in range(0, n_contigs - 1, 2):
        tb = ta + 1
        refa, refb = contigs[ta][1], contigs[tb][1]
        bp_a = contig_len * 9 // 10
        bp_b = contig_len // 10
        truth.append(("BND", contigs[ta][0], bp_a,
                      contigs[tb][0], bp_b))
        bnd_hap = refa[:bp_a] + refb[bp_b:]
        for _ in range(pe_per_sv):
            off = rng.randint(60, 250)
            p1 = bp_a - off - rl
            p2 = bp_b + (isize - off - 2 * rl) + rng.randint(0, 30)
            rec(ta, p1, f"t{qid}", 0x61, ta, p1, 60, [("M", rl)],
                tb, p2, 0, err(refa[p1:p1 + rl]))
            rec(tb, p2, f"t{qid}", 0x91, tb, p2, 60, [("M", rl)],
                ta, p1, 0, err(refb[p2:p2 + rl]))
            qid += 1
        for _ in range(sr_per_sv):
            off = rng.randint(25, 70)
            dpos = bp_a - off
            seq = err(bnd_hap[dpos:dpos + rl])
            rec(ta, dpos, f"x{qid}", 0x0, ta, dpos, 60,
                [("M", off), ("S", rl - off)], -1, -1, 0, seq)
            rec(tb, bp_b, f"x{qid}", 0x800, tb, bp_b, 60,
                [("S", off), ("M", rl - off)], -1, -1, 0, seq)
            qid += 1

    recs.sort(key=lambda r: (r[0], r[1]))
    blobs = []
    for tid, (bpos, bbuf, rec_w) in enumerate(bulk):
        ev = [(p, b) for t, p, b in recs if t == tid]
        blobs += _merge_sorted_blobs(bpos, bbuf, rec_w, ev)
    bam = f"{tmpdir}/{name}.bam"
    fa = f"{tmpdir}/{name}.fa"
    write_bam(bam, contigs, blobs)
    write_fasta(fa, contigs)
    return bam, fa, truth


# the long-split run of chip_smoke.py: 24 het 5 kb DELs, each seen by
# two ~12 kb split reads
LONG_SPLIT = dict(n_contigs=4, contig_len=1_000_000, dels_per_contig=6,
                  reads_per_del=2, read_len=12_000, jitter=200,
                  pairs_per_contig=20_000)


def make_long_split_dataset(tmpdir, n_contigs=1, contig_len=400_000,
                            dels_per_contig=1, reads_per_del=2,
                            read_len=12_000, jitter=200,
                            pairs_per_contig=6000, del_len=5000, seed=211,
                            name="longsplit"):
    """Het DELs seen through long split reads, the regime where `sr`'s
    split-read MSA merges sequences longer than 8,192 bases and takes
    the corridor DP. Per DEL, `reads_per_del` reads of the deleted
    haplotype span the junction: each starts read_len // 2 before it,
    with its start and its length each shifted uniformly within
    +-`jitter`; the primary record is M,S at the read's start and the
    supplementary S,M at the DEL's end, under the same name. Normal
    100 bp pairs give the library statistics. Returns (bam, fasta,
    truth) with truth [("DEL", chrom, start, end)]."""
    rng = random.Random(seed)
    contigs = [(f"chr{c + 1}", random_contig(rng, contig_len))
               for c in range(n_contigs)]
    rl, isize = 100, 400
    recs = []
    bulk = []
    truth = []
    qid = 0
    for tid, (cname, ref) in enumerate(contigs):
        spacing = contig_len // (dels_per_contig + 1)
        for k in range(dels_per_contig):
            bp1 = spacing * (k + 1)
            bp2 = bp1 + del_len
            truth.append(("DEL", cname, bp1, bp2))
            for _ in range(reads_per_del):
                start = bp1 - read_len // 2 + rng.randint(-jitter, jitter)
                length = read_len + rng.randint(-jitter, jitter)
                off = bp1 - start
                seq = ref[start:bp1] + ref[bp2:bp2 + length - off]
                recs.append((tid, start, encode_record(
                    f"l{qid}", 0x0, tid, start, 60,
                    [("M", off), ("S", length - off)], -1, -1, 0, seq)))
                recs.append((tid, bp2, encode_record(
                    f"l{qid}", 0x800, tid, bp2, 60,
                    [("S", off), ("M", length - off)], -1, -1, 0, seq)))
                qid += 1
        g = np.random.default_rng(rng.randint(0, 2**31))
        isz = isize + g.integers(-60, 61, size=pairs_per_contig)
        p1 = g.integers(0, contig_len - isz.max() - 1,
                        size=pairs_per_contig)
        ref_u8 = np.frombuffer(ref.encode(), dtype=np.uint8)
        bulk.append(_bulk_pair_records(tid, ref_u8, p1, isz, qid, rl=rl,
                                       seed=rng.randint(0, 2**31)))
        qid += pairs_per_contig

    recs.sort(key=lambda r: (r[0], r[1]))
    blobs = []
    for tid, (bpos, bbuf, rec_w) in enumerate(bulk):
        ev = [(p, b) for t, p, b in recs if t == tid]
        blobs += _merge_sorted_blobs(bpos, bbuf, rec_w, ev)
    bam = f"{tmpdir}/{name}.bam"
    fa = f"{tmpdir}/{name}.fa"
    write_bam(bam, contigs, blobs)
    write_fasta(fa, contigs)
    return bam, fa, truth


def make_lr_genome_dataset(tmpdir, n_contigs=4, contig_len=1_000_000,
                           reads_per_contig=250, read_len=4000,
                           var_reads=12, seed=83, name="lrbig",
                           error_rate=0.0, indel_error_rate=0.0):
    """Genome-scale long-read dataset: per contig one ~1kb DEL (D op)
    and one 500bp INS (I op), heterozygous (var_reads carriers each),
    plus background reads. Returns (bam, fasta, truth) with truth =
    [(chrom, kind, pos, length)]. error_rate adds substitution noise;
    indel_error_rate adds 1bp I/D noise with matching CIGARs (ONT
    error realism)."""
    rng = random.Random(seed)
    g = np.random.default_rng(seed + 1)

    def seg(ref_seq):
        return noisy_segment(g, ref_seq, error_rate, indel_error_rate)

    def cat(*parts):
        # parts: (ops, seq) or a bare structural op like (("D", n), "")
        ops, seq = [], []
        for po, ps in parts:
            for op, ln in po:
                if ops and ops[-1][0] == op:
                    ops[-1] = (op, ops[-1][1] + ln)
                else:
                    ops.append((op, ln))
            seq.append(ps)
        return ops, "".join(seq)
    contigs = [(f"chr{c + 1}", random_contig(rng, contig_len))
               for c in range(n_contigs)]
    del_len, ins_len = 1000, 500
    recs = []
    truth = []
    qid = 0
    for tid, (cname, ref) in enumerate(contigs):
        posd = contig_len // 3
        posi = 2 * contig_len // 3
        ins_seq = random_contig(rng, ins_len)
        truth.append((cname, "DEL", posd, del_len))
        truth.append((cname, "INS", posi, ins_len))
        # background reads
        for _ in range(reads_per_contig):
            p = rng.randint(0, contig_len - read_len - 1)
            ops, seq = seg(ref[p:p + read_len])
            recs.append((tid, p, encode_record(
                f"b{qid}", 0x0, tid, p, 60, ops, -1, -1, 0, seq)))
            qid += 1
        # DEL carriers: M(lo) D(del_len) M(hi)
        for _ in range(var_reads):
            lo = rng.randint(800, 1800)
            hi = rng.randint(800, 1800)
            p = posd - lo
            ops, seq = cat(seg(ref[p:posd]), ([("D", del_len)], ""),
                           seg(ref[posd + del_len:
                                   posd + del_len + hi]))
            recs.append((tid, p, encode_record(
                f"d{qid}", 0x0, tid, p, 60, ops, -1, -1, 0, seq)))
            qid += 1
        # INS carriers: M(lo) I(ins_len) M(hi)
        for _ in range(var_reads):
            lo = rng.randint(800, 1800)
            hi = rng.randint(800, 1800)
            p = posi - lo
            ins_noisy = add_read_errors(rng, ins_seq, error_rate)
            ops, seq = cat(seg(ref[p:posi]),
                           ([("I", len(ins_noisy))], ins_noisy),
                           seg(ref[posi:posi + hi]))
            recs.append((tid, p, encode_record(
                f"i{qid}", 0x0, tid, p, 60, ops, -1, -1, 0, seq)))
            qid += 1
    recs.sort(key=lambda r: (r[0], r[1]))
    bam = f"{tmpdir}/{name}.bam"
    fa = f"{tmpdir}/{name}.fa"
    write_bam(bam, contigs, [r[2] for r in recs])
    write_fasta(fa, contigs)
    return bam, fa, truth


def make_deep_lr_dataset(tmpdir, n_contigs=2, contig_len=1_000_000,
                         dels_per_contig=100, coverage=45,
                         var_reads=15, read_len=4000, seed=167,
                         name="deeplr"):
    """Deep-coverage LONG-READ genotyping regime (genotype.h:93-397):
    many het ~1kb DELs under ~coverage x of 4kb reads. Every read
    overlapping a breakpoint scores REF/ALT probes with
    ~(2*offset)^2-cell NW DPs — the large-DP regime where the device
    kernel dominates the pipeline. Returns (bam, fa, truth)."""
    rng = random.Random(seed)
    contigs = [(f"chr{c + 1}", random_contig(rng, contig_len))
               for c in range(n_contigs)]
    del_len = 1000
    recs = []
    truth = []
    qid = 0
    for tid, (cname, ref) in enumerate(contigs):
        spacing = contig_len // (dels_per_contig + 1)
        dels = []
        for k in range(dels_per_contig):
            posd = spacing * (k + 1)
            if posd + del_len + read_len >= contig_len:
                continue
            dels.append(posd)
            truth.append((cname, "DEL", posd, del_len))
            for _ in range(var_reads):
                lo = rng.randint(800, 1800)
                hi = rng.randint(800, 1800)
                p = posd - lo
                seq = (ref[p:posd]
                       + ref[posd + del_len:posd + del_len + hi])
                recs.append((tid, p, encode_record(
                    f"d{qid}", 0x0, tid, p, 60,
                    [("M", lo), ("D", del_len), ("M", hi)],
                    -1, -1, 0, seq)))
                qid += 1
        nreads = coverage * contig_len // (2 * read_len)  # het: alt
        # carriers above carry ~half the depth at breakpoints
        for _ in range(nreads):
            p = rng.randint(0, contig_len - read_len - 1)
            recs.append((tid, p, encode_record(
                f"b{qid}", 0x0, tid, p, 60, [("M", read_len)],
                -1, -1, 0, ref[p:p + read_len])))
            qid += 1
    recs.sort(key=lambda r: (r[0], r[1]))
    bam = f"{tmpdir}/{name}.bam"
    fa = f"{tmpdir}/{name}.fa"
    write_bam(bam, contigs, [r[2] for r in recs])
    write_fasta(fa, contigs)
    return bam, fa, truth


def make_lr_sv_dataset(tmpdir, seed=103, name="lrsv", contig_len=140_000,
                       read_len=4000, var_reads=12, bg_reads=120):
    """Long-read mixed-SV dataset: split-alignment evidence for a
    tandem DUP, an INV (reverse-strand supplementary) and a
    cross-contig BND, plus CIGAR-op DEL and INS — the five families
    through the lr junction walk (junction.h:319-460 select* paths).
    Returns (bam, fasta, truth)."""
    rng = random.Random(seed)
    ref1 = random_contig(rng, contig_len)
    ref2 = random_contig(rng, contig_len)
    contigs = [("ctgA", ref1), ("ctgB", ref2)]
    h = read_len // 2
    recs = []
    qid = 0

    def bg(tid, ref):
        nonlocal qid
        for _ in range(bg_reads):
            p = rng.randint(0, len(ref) - read_len)
            recs.append((tid, p, encode_record(
                f"b{qid}", 0x0, tid, p, 60, [("M", read_len)], -1, -1,
                0, ref[p:p + read_len])))
            qid += 1

    bg(0, ref1)
    bg(1, ref2)

    # DEL (D op) at ctgA 20000, 1200bp
    del_bp, del_len = 20_000, 1200
    for _ in range(var_reads):
        lo = rng.randint(1200, 2400)
        hi = read_len - lo
        p = del_bp - lo
        seq = ref1[p:del_bp] + ref1[del_bp + del_len:del_bp + del_len + hi]
        recs.append((0, p, encode_record(
            f"d{qid}", 0x0, 0, p, 60,
            [("M", lo), ("D", del_len), ("M", hi)], -1, -1, 0, seq)))
        qid += 1

    # INS (I op) at ctgA 45000, 500bp novel
    ins_bp = 45_000
    ins_seq = "".join(rng.choice("ACGT") for _ in range(500))
    for _ in range(var_reads):
        lo = rng.randint(1200, 2000)
        hi = read_len - lo - len(ins_seq)
        p = ins_bp - lo
        seq = ref1[p:ins_bp] + ins_seq + ref1[ins_bp:ins_bp + hi]
        recs.append((0, p, encode_record(
            f"i{qid}", 0x0, 0, p, 60,
            [("M", lo), ("I", len(ins_seq)), ("M", hi)], -1, -1, 0,
            seq)))
        qid += 1

    # DUP at ctgA [70000, 74000): split reads over the copy junction
    dup1, dup2 = 70_000, 74_000
    for _ in range(var_reads):
        seq = ref1[dup2 - h:dup2] + ref1[dup1:dup1 + h]
        p = dup2 - h
        recs.append((0, p, encode_record(
            f"u{qid}", 0x0, 0, p, 60, [("M", h), ("S", h)], -1, -1, 0,
            seq)))
        recs.append((0, dup1, encode_record(
            f"u{qid}", 0x800, 0, dup1, 60, [("S", h), ("M", h)],
            -1, -1, 0, seq)))
        qid += 1

    # INV at ctgA [100000, 106000): read crosses the left boundary into
    # the inverted segment; the supplementary is reverse-strand
    inv1, inv2 = 100_000, 106_000
    for _ in range(var_reads):
        seq = ref1[inv1 - h:inv1] + revcomp(ref1[inv2 - h:inv2])
        p = inv1 - h
        recs.append((0, p, encode_record(
            f"v{qid}", 0x0, 0, p, 60, [("M", h), ("S", h)], -1, -1, 0,
            seq)))
        # reverse-strand supplementary: stored SEQ is revcomp(read),
        # CIGAR in reference orientation
        recs.append((0, inv2 - h, encode_record(
            f"v{qid}", 0x810, 0, inv2 - h, 60, [("M", h), ("S", h)],
            -1, -1, 0, revcomp(seq))))
        qid += 1

    # BND ctgA:125000 (3') -> ctgB:30000 (5'). Half the reads carry the
    # primary on each side: the assembly's translocation MSA runs at
    # refIndex == sv.chr and needs srStore entries there (primaries all
    # on one side leave the other chromosome's store empty and the SV
    # unassembled — reference assemble.h:768-770 behaves identically).
    bnd_a, bnd_b = 125_000, 30_000
    for k in range(var_reads):
        seq = ref1[bnd_a - h:bnd_a] + ref2[bnd_b:bnd_b + h]
        p = bnd_a - h
        fl_a, fl_b = (0x0, 0x800) if k % 2 == 0 else (0x800, 0x0)
        recs.append((0, p, encode_record(
            f"x{qid}", fl_a, 0, p, 60, [("M", h), ("S", h)], -1, -1, 0,
            seq)))
        recs.append((1, bnd_b, encode_record(
            f"x{qid}", fl_b, 1, bnd_b, 60, [("S", h), ("M", h)],
            -1, -1, 0, seq)))
        qid += 1

    truth = [("DEL", "ctgA", del_bp, del_bp + del_len),
             ("INS", "ctgA", ins_bp, ins_bp),
             ("DUP", "ctgA", dup1, dup2),
             ("INV", "ctgA", inv1, inv2),
             ("BND", "ctgA", bnd_a, "ctgB", bnd_b)]
    recs.sort(key=lambda r: (r[0], r[1]))
    bam = f"{tmpdir}/{name}.bam"
    fa = f"{tmpdir}/{name}.fa"
    write_bam(bam, contigs, [r[2] for r in recs])
    write_fasta(fa, contigs)
    return bam, fa, truth


_HDR_DT = np.dtype([("bs", "<i4"), ("tid", "<i4"), ("pos", "<i4"),
                    ("lrn", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                    ("ncig", "<u2"), ("flag", "<u2"), ("lseq", "<i4"),
                    ("mtid", "<i4"), ("mpos", "<i4"), ("tlen", "<i4")])


def make_deep_geno_dataset(tmpdir, n_contigs=2, contig_len=600_000,
                           dels_per_contig=150, coverage=45,
                           sr_per_sv=8, pe_per_sv=10, seed=131,
                           name="deepgeno"):
    """Deep-coverage genotyping regime (coverage.h:271): many het DELs
    (SR+PE evidence) under ~coverage x of normal pairs, so the
    per-read x per-SV junction realignment DP dominates the pipeline.
    Returns (bam, fa, truth)."""
    rng = random.Random(seed)
    contigs = [(f"chr{c + 1}",
                random_contig(rng, contig_len,
                              gc_blocks=max(1, contig_len // 10_000)))
               for c in range(n_contigs)]
    rl, isize = 100, 400
    recs = []          # (tid, pos, blob) evidence records
    bulk = []
    truth = []
    qid = 0

    def rec(tid, pos, *args):
        recs.append((tid, pos, encode_record(*args)))

    for tid, (cname, ref) in enumerate(contigs):
        spacing = contig_len // (dels_per_contig + 1)
        for k in range(dels_per_contig):
            bp1 = spacing * (k + 1)
            size = 800 + (k % 5) * 200
            bp2 = bp1 + size
            if bp2 + isize + rl >= contig_len:
                continue
            truth.append(("DEL", cname, bp1, bp2))
            for _ in range(pe_per_sv):
                off = rng.randint(30, 200)
                p1 = bp1 - off - rl
                p2 = bp2 + (isize - off - 2 * rl) + rng.randint(0, 40)
                tl = p2 + rl - p1
                rec(tid, p1, f"d{qid}", 0x61, tid, p1, 60,
                    [("M", rl)], tid, p2, tl, ref[p1:p1 + rl])
                rec(tid, p2, f"d{qid}", 0x91, tid, p2, 60,
                    [("M", rl)], tid, p1, -tl, ref[p2:p2 + rl])
                qid += 1
            for _ in range(sr_per_sv):
                off = rng.randint(30, 70)
                dpos = bp1 - off
                seq = ref[bp1 - off:bp1] + ref[bp2:bp2 + rl - off]
                rec(tid, dpos, f"s{qid}", 0x0, tid, dpos, 60,
                    [("M", off), ("S", rl - off)], -1, -1, 0, seq)
                rec(tid, bp2, f"s{qid}", 0x800, tid, bp2, 60,
                    [("S", off), ("M", rl - off)], -1, -1, 0, seq)
                qid += 1

    # deep normal background as bulk buffers (fast path)
    qid0 = 10_000_000
    for tid, (cname, ref) in enumerate(contigs):
        ref_u8 = np.frombuffer(ref.encode(), dtype=np.uint8)
        npairs = coverage * contig_len // (2 * rl)
        g = np.random.default_rng(seed + 7 * tid)
        p1 = np.sort(g.integers(0, contig_len - isize - 1,
                                size=npairs)).astype(np.int64)
        bulk.append(_bulk_pair_records(tid, ref_u8, p1, isize, qid0,
                                       rl=rl, seed=seed + 7 * tid))
        qid0 += npairs

    recs.sort(key=lambda r: (r[0], r[1]))
    blobs = []
    for tid, (bpos, bbuf, rec_w) in enumerate(bulk):
        ev = [(p, b) for t, p, b in recs if t == tid]
        blobs += _merge_sorted_blobs(bpos, bbuf, rec_w, ev)
    bam = f"{tmpdir}/{name}.bam"
    fa = f"{tmpdir}/{name}.fa"
    write_bam(bam, contigs, blobs)
    write_fasta(fa, contigs)
    return bam, fa, truth


def _bulk_pair_records(tid, ref_u8, p1, isz, qid0, rl=100,
                       error_rate=0.0, seed=0):
    """Fixed-shape normal read pairs ((M, rl) CIGAR, flags 0x63/0x93)
    as one structured-array buffer. Returns (pos, buf, rec_w) with
    `pos` the per-record positions in buffer order (unsorted)."""
    n = len(p1)
    g = np.random.default_rng(seed)
    p2 = p1 + isz - rl
    name_w = 12              # b"p%010d\0"
    rec_dt = np.dtype([("hdr", _HDR_DT), ("name", f"S{name_w}"),
                       ("cig", "<u4"), ("seq", "u1", (rl // 2,)),
                       ("qual", "u1", (rl,))])
    assert rec_dt.itemsize == 4 + 32 + name_w + 4 + rl // 2 + rl
    out = np.zeros(2 * n, dtype=rec_dt)
    hdr = out["hdr"]
    hdr["bs"] = rec_dt.itemsize - 4
    hdr["tid"] = tid
    hdr["mtid"] = tid
    hdr["lrn"] = name_w
    hdr["mapq"] = 60
    hdr["ncig"] = 1
    hdr["lseq"] = rl
    hdr["pos"][0::2] = p1
    hdr["pos"][1::2] = p2
    hdr["mpos"][0::2] = p2
    hdr["mpos"][1::2] = p1
    hdr["flag"][0::2] = 0x63
    hdr["flag"][1::2] = 0x93
    hdr["tlen"][0::2] = isz
    hdr["tlen"][1::2] = -isz
    # names: p + zero-padded qid, identical for both mates
    qids = qid0 + np.arange(n, dtype=np.int64)
    digits = np.empty((n, 10), dtype=np.uint8)
    v = qids.copy()
    for k in range(9, -1, -1):
        digits[:, k] = (v % 10) + ord("0")
        v //= 10
    names = np.zeros((n, name_w), dtype=np.uint8)
    names[:, 0] = ord("p")
    names[:, 1:11] = digits
    nview = names.view(f"S{name_w}").reshape(n)
    out["name"][0::2] = nview
    out["name"][1::2] = nview
    out["cig"] = (rl << 4) | 0       # M
    # sequences gathered from the reference
    win = np.arange(rl, dtype=np.int64)
    s1 = ref_u8[p1[:, None] + win]
    s2 = ref_u8[p2[:, None] + win]
    if error_rate > 0:
        letters = np.frombuffer(b"ACGT", dtype=np.uint8)
        for s in (s1, s2):
            hit = g.random(s.shape) < error_rate
            codes = np.searchsorted(letters, s[hit]) % 4
            s[hit] = letters[(codes + g.integers(1, 4, hit.sum())) % 4]
    for row, s in ((0, s1), (1, s2)):
        codes = _NT16_LUT[s]
        out["seq"][row::2] = (codes[:, 0::2] << 4) | codes[:, 1::2]
    out["qual"] = 30
    pos = np.empty(2 * n, dtype=np.int64)
    pos[0::2] = p1
    pos[1::2] = p2
    return pos, out, rec_dt.itemsize


def _merge_sorted_blobs(pos, buf, rec_w, evidence):
    """Merge a bulk record buffer with a small list of (pos, blob)
    evidence records into position order. Returns a list of byte
    blobs whose concatenation is the sorted record stream."""
    order = np.argsort(pos, kind="stable")
    raw = np.ascontiguousarray(buf[order]).tobytes()
    spos = pos[order]
    if not evidence:
        return [raw]
    evidence = sorted(evidence, key=lambda e: e[0])
    epos = np.asarray([e[0] for e in evidence], dtype=np.int64)
    cut = np.searchsorted(spos, epos, side="right") * rec_w
    blobs = []
    prev = 0
    for k, (_p, blob) in enumerate(evidence):
        if cut[k] > prev:
            blobs.append(raw[prev:cut[k]])
            prev = cut[k]
        blobs.append(blob)
    if prev < len(raw):
        blobs.append(raw[prev:])
    return blobs


def make_multi_contig_del_dataset(tmpdir, n_contigs=4, contig_len=60_000,
                                  pairs_per_contig=900, sr_per_del=10,
                                  pe_per_del=14, seed=77, name="multi",
                                  error_rate=0.0):
    """`n_contigs` contigs, one heterozygous ~8kb DEL per contig with
    both PE (discordant spanning pairs) and SR (primary+supplementary
    split reads) evidence, plus normal pairs for library statistics.
    Returns (bam_path, fasta_path, truth) with truth = [(chrom_name,
    del_start, del_end)]. Scales to benchmark size via the count
    parameters."""
    rng = random.Random(seed)
    contigs = [(f"chr{c + 1}",
                random_contig(rng, contig_len,
                              gc_blocks=max(1, contig_len // 10_000)))
               for c in range(n_contigs)]
    rl = 100
    isize = 400
    del_len = 8000
    truth = []
    blobs = []
    qid = 0
    for tid, (cname, ref) in enumerate(contigs):
        bp1 = contig_len * 2 // 5
        bp2 = bp1 + del_len
        truth.append((cname, bp1, bp2))
        derived = ref[:bp1] + ref[bp2:]
        # homozygous read-depth hole (a CN0 region for the cnv engine;
        # carries no PE/SR signal so the sr truth set is unaffected)
        hole_lo = contig_len * 4 // 5
        hole_hi = hole_lo + min(60_000, contig_len // 10)
        # normal pairs, bulk-vectorized (insert-size spread so MAD > 0:
        # the scan's strict normal-insert bounds need real variance,
        # scan.h:151)
        g = np.random.default_rng(rng.randint(0, 2**31))
        isz = isize + g.integers(-60, 61, size=pairs_per_contig)
        p1 = g.integers(0, contig_len - isz.max() - 1,
                        size=pairs_per_contig)
        keep = ~((hole_lo - isz < p1) & (p1 < hole_hi))
        isz, p1 = isz[keep], p1[keep]
        ref_u8 = np.frombuffer(ref.encode(), dtype=np.uint8)
        bpos, bbuf, rec_w = _bulk_pair_records(
            tid, ref_u8, p1, isz, qid, rl=rl, error_rate=error_rate,
            seed=rng.randint(0, 2**31))
        qid += len(p1)
        recs = []
        # discordant pairs spanning the deletion (3to5, large insert)
        for _ in range(pe_per_del):
            off = rng.randint(30, 200)
            p1 = bp1 - off - rl
            p2 = bp2 + (isize - off - 2 * rl) + rng.randint(0, 40)
            tl = p2 + rl - p1
            recs.append((tid, p1, encode_record(
                f"d{qid}", 0x61, tid, p1, 60, [("M", rl)], tid, p2,
                tl, add_read_errors(rng, ref[p1:p1 + rl], error_rate))))
            recs.append((tid, p2, encode_record(
                f"d{qid}", 0x91, tid, p2, 60, [("M", rl)], tid, p1,
                -tl, add_read_errors(rng, ref[p2:p2 + rl], error_rate))))
            qid += 1
        # split reads across the junction: primary M+S at bp1,
        # supplementary S+M at bp2 (same read name -> same seed)
        for _ in range(sr_per_del):
            off = rng.randint(30, 70)
            dpos = bp1 - off
            seq = add_read_errors(rng, derived[dpos:dpos + rl], error_rate)
            recs.append((tid, dpos, encode_record(
                f"s{qid}", 0x0, tid, dpos, 60,
                [("M", off), ("S", rl - off)], -1, -1, 0, seq)))
            recs.append((tid, bp2, encode_record(
                f"s{qid}", 0x800, tid, bp2, 60,
                [("S", off), ("M", rl - off)], -1, -1, 0, seq)))
            qid += 1
        blobs += _merge_sorted_blobs(bpos, bbuf, rec_w,
                                     [(p, b) for _t, p, b in recs])
    bam = f"{tmpdir}/{name}.bam"
    fa = f"{tmpdir}/{name}.fa"
    write_bam(bam, contigs, blobs)
    write_fasta(fa, contigs)
    return bam, fa, truth


def make_population_cohort(tmpdir, n_samples=50, n_contigs=2,
                           contig_len=300_000, n_svs=30,
                           pairs_per_contig=18_000, seed=211,
                           name="cohort"):
    """Population cohort over one shared genome: `n_svs` het DELs
    with drawn allele frequencies; sample s carries SV i with
    probability af[i]. Returns (bam_paths, fa, truth) with
    truth = [(chrom, bp1, bp2, af, frozenset(carrier sample idx))].

    The reference's germline workflow corpus (README.md:75-99):
    per-sample discovery -> merge -> per-sample -v genotyping ->
    sample merge -> germline filter."""
    rng = random.Random(seed)
    contigs = [(f"chr{c + 1}",
                random_contig(rng, contig_len,
                              gc_blocks=max(1, contig_len // 10_000)))
               for c in range(n_contigs)]
    rl, isize = 100, 400
    # population sites: spaced DELs, sizes 500-6000, AF in [0.1, 0.9]
    sites = []
    per_chr = -(-n_svs // n_contigs)
    for tid in range(n_contigs):
        spacing = (contig_len - 40_000) // (per_chr + 1)
        for k in range(per_chr):
            if len(sites) >= n_svs:
                break
            bp1 = 20_000 + spacing * (k + 1)
            size = 500 + (k * 997) % 5500
            sites.append((tid, bp1, bp1 + size,
                          0.1 + 0.8 * rng.random()))
    carriers = [frozenset(s for s in range(n_samples)
                          if rng.random() < af)
                for (_t, _a, _b, af) in sites]
    truth = [(contigs[t][0], a, b, round(af, 3), carriers[i])
             for i, (t, a, b, af) in enumerate(sites)]

    fa = f"{tmpdir}/{name}.fa"
    write_fasta(fa, contigs)
    bam_paths = []
    for s in range(n_samples):
        recs = []
        qid = 0

        def rec(tid, pos, *args):
            recs.append((tid, pos, encode_record(*args)))

        for i, (tid, bp1, bp2, _af) in enumerate(sites):
            if s not in carriers[i]:
                continue
            ref = contigs[tid][1]
            for _ in range(8):
                off = rng.randint(30, 200)
                p1 = bp1 - off - rl
                p2 = bp2 + (isize - off - 2 * rl) + rng.randint(0, 40)
                tl = p2 + rl - p1
                rec(tid, p1, f"d{s}_{qid}", 0x61, tid, p1, 60,
                    [("M", rl)], tid, p2, tl, ref[p1:p1 + rl])
                rec(tid, p2, f"d{s}_{qid}", 0x91, tid, p2, 60,
                    [("M", rl)], tid, p1, -tl, ref[p2:p2 + rl])
                qid += 1
            for _ in range(7):
                off = rng.randint(30, 70)
                dpos = bp1 - off
                seq = ref[bp1 - off:bp1] + ref[bp2:bp2 + rl - off]
                rec(tid, dpos, f"s{s}_{qid}", 0x0, tid, dpos, 60,
                    [("M", off), ("S", rl - off)], -1, -1, 0, seq)
                rec(tid, bp2, f"s{s}_{qid}", 0x800, tid, bp2, 60,
                    [("S", off), ("M", rl - off)], -1, -1, 0, seq)
                qid += 1
        bulk = []
        for tid, (cname, ref) in enumerate(contigs):
            ref_u8 = np.frombuffer(ref.encode(), dtype=np.uint8)
            g = np.random.default_rng(seed + 1000 * s + tid)
            p1 = np.sort(g.integers(0, contig_len - isize - 1,
                                    size=pairs_per_contig)
                         ).astype(np.int64)
            # het coverage loss: carriers lose ~half the fragments
            # whose midpoint falls inside a carried deletion (the
            # germline filter's RD-ratio gate demands it, as on real
            # data)
            mid = p1 + isize // 2
            drop = np.zeros(len(p1), dtype=bool)
            for i, (t2, bp1s, bp2s, _af) in enumerate(sites):
                if t2 == tid and s in carriers[i]:
                    inside = (mid >= bp1s) & (mid < bp2s)
                    drop |= inside & (g.random(len(p1)) < 0.5)
            p1 = p1[~drop]
            bulk.append(_bulk_pair_records(
                tid, ref_u8, p1, isize, 10_000_000 + s * 100_000,
                rl=rl, seed=seed + 1000 * s + tid))
        recs.sort(key=lambda r: (r[0], r[1]))
        blobs = []
        for tid, (bpos, bbuf, rec_w) in enumerate(bulk):
            ev = [(p, b) for t, p, b in recs if t == tid]
            blobs += _merge_sorted_blobs(bpos, bbuf, rec_w, ev)
        path = f"{tmpdir}/{name}_s{s:03d}.bam"
        write_bam(path, contigs, blobs, sample=f"S{s:03d}")
        bam_paths.append(path)
    return bam_paths, fa, truth


def make_somatic_pair_dataset(tmpdir, n_contigs=2, contig_len=100_000,
                              pairs_per_contig=1400, seed=97):
    """Tumor/control pair over a shared genome: one GERMLINE ~6kb DEL
    per contig (PE+SR evidence in BOTH files) and one SOMATIC ~5kb DEL
    per contig (evidence in the tumor only). Returns
    (tumor_bam, control_bam, fasta, germline_truth, somatic_truth)."""
    rng = random.Random(seed)
    contigs = [(f"chr{c + 1}",
                random_contig(rng, contig_len,
                              gc_blocks=max(1, contig_len // 10_000)))
               for c in range(n_contigs)]
    rl, isize = 100, 400
    germ, soma = [], []
    recs = {"tumor": [], "control": []}
    qid = 0

    def emit_del(who, tid, ref, bp1, bp2, sr_n=10, pe_n=14):
        nonlocal qid
        derived = ref[:bp1] + ref[bp2:]
        for _ in range(pe_n):
            off = rng.randint(30, 200)
            p1 = bp1 - off - rl
            p2 = bp2 + (isize - off - 2 * rl) + rng.randint(0, 40)
            tl = p2 + rl - p1
            recs[who].append((tid, p1, encode_record(
                f"d{qid}", 0x61, tid, p1, 60, [("M", rl)], tid, p2, tl,
                ref[p1:p1 + rl])))
            recs[who].append((tid, p2, encode_record(
                f"d{qid}", 0x91, tid, p2, 60, [("M", rl)], tid, p1,
                -tl, ref[p2:p2 + rl])))
            qid += 1
        for _ in range(sr_n):
            off = rng.randint(30, 70)
            dpos = bp1 - off
            seq = derived[dpos:dpos + rl]
            recs[who].append((tid, dpos, encode_record(
                f"s{qid}", 0x0, tid, dpos, 60,
                [("M", off), ("S", rl - off)], -1, -1, 0, seq)))
            recs[who].append((tid, bp2, encode_record(
                f"s{qid}", 0x800, tid, bp2, 60,
                [("S", off), ("M", rl - off)], -1, -1, 0, seq)))
            qid += 1

    for tid, (cname, ref) in enumerate(contigs):
        bp1g = contig_len * 3 // 10
        bp2g = bp1g + 6000
        bp1s = contig_len * 6 // 10
        bp2s = bp1s + 5000
        germ.append((cname, bp1g, bp2g))
        soma.append((cname, bp1s, bp2s))
        for who in ("tumor", "control"):
            for _ in range(pairs_per_contig):
                isz = isize + rng.randint(-60, 60)
                p1 = rng.randint(0, contig_len - isz - 1)
                p2 = p1 + isz - rl
                recs[who].append((tid, p1, encode_record(
                    f"p{qid}", 0x63, tid, p1, 60, [("M", rl)], tid, p2,
                    isz, ref[p1:p1 + rl])))
                recs[who].append((tid, p2, encode_record(
                    f"p{qid}", 0x93, tid, p2, 60, [("M", rl)], tid, p1,
                    -isz, ref[p2:p2 + rl])))
                qid += 1
            emit_del(who, tid, ref, bp1g, bp2g)
        emit_del("tumor", tid, ref, bp1s, bp2s)

    fa = f"{tmpdir}/som.fa"
    write_fasta(fa, contigs)
    paths = {}
    for who in ("tumor", "control"):
        recs[who].sort(key=lambda r: (r[0], r[1]))
        p = f"{tmpdir}/{who}.bam"
        write_bam(p, contigs, [r[2] for r in recs[who]], sample=who)
        paths[who] = p
    return paths["tumor"], paths["control"], fa, germ, soma


def make_asm_indel_dataset(tmpdir, contig_len=1_500_000, seed=7,
                           name="asm"):
    """One haplotype assembly alignment pair for ``asm`` (squashed):
    two identical contig-length alignments of one contig, each with a
    1,200 bp DEL at a third and a 600 bp novel INS at two thirds of it,
    both as CIGAR indels. Returns (bam, fasta, truth) with truth =
    [("DEL", pos), ("INS", pos)]."""
    rng = random.Random(seed)
    L = contig_len
    ref = random_contig(rng, L)
    posd, dell = L // 3, 1200
    posi, insl = 2 * L // 3, 600
    ins_seq = random_contig(rng, insl)
    contigs = [("chr1", ref)]

    def hap(qname):
        cig = [("M", posd), ("D", dell),
               ("M", posi - (posd + dell)), ("I", insl),
               ("M", L - posi)]
        seq = ref[:posd] + ref[posd + dell:posi] + ins_seq + ref[posi:]
        return encode_record(qname, 0x0, 0, 0, 60, cig, -1, -1, 0, seq)

    bam = f"{tmpdir}/{name}.bam"
    fa = f"{tmpdir}/{name}.fa"
    write_bam(bam, contigs, [hap("h1"), hap("h2")])
    write_fasta(fa, contigs)
    return bam, fa, [("DEL", posd), ("INS", posi)]


def make_asm_diploid_dataset(tmpdir, contig_len=2_000_000, seed=91,
                             name="asm"):
    """Two haplotype assemblies of one sample for ``asm -y diploid``,
    one contig-length alignment each: a DEL of 1,200 bp at a third of
    the contig on both haplotypes (homozygous) and a novel INS of 600
    bp at two thirds on the first only (heterozygous). Returns
    ((hap1_bam, hap2_bam), fasta, truth) with truth = [("DEL", pos,
    "1/1"), ("INS", pos, "het")]."""
    rng = random.Random(seed)
    L = contig_len
    ref = random_contig(rng, L)
    posd, dell = L // 3, 1200
    posi, insl = 2 * L // 3, 600
    ins_seq = random_contig(rng, insl)

    def hap(qname, with_ins):
        cig = [("M", posd), ("D", dell)]
        seq = ref[:posd]
        if with_ins:
            cig += [("M", posi - (posd + dell)), ("I", insl),
                    ("M", L - posi)]
            seq += ref[posd + dell:posi] + ins_seq + ref[posi:]
        else:
            cig += [("M", L - (posd + dell))]
            seq += ref[posd + dell:]
        return encode_record(qname, 0x0, 0, 0, 60, cig, -1, -1, 0, seq)

    h1 = f"{tmpdir}/{name}_h1.bam"
    h2 = f"{tmpdir}/{name}_h2.bam"
    fa = f"{tmpdir}/{name}.fa"
    write_bam(h1, [("chr1", ref)], [hap("s.hap1", True)])
    write_bam(h2, [("chr1", ref)], [hap("s.hap2", False)])
    write_fasta(fa, [("chr1", ref)])
    return (h1, h2), fa, [("DEL", posd, "1/1"), ("INS", posi, "het")]


def make_asm_split_dataset(tmpdir, contig_len=200_000, seed=7,
                           name="asm"):
    """Assembly alignments with split-contig evidence for ``asm``: a
    DUP (12 kb copy junction) and an INV (reverse-strand supplementary)
    on ctgA, and a BND ctgA -> ctgB carried by two samples (a
    translocation needs two supporting samples to pass the merge).
    Each contig piece is 30 kb. Returns ((bam_s1, bam_s2), fasta, truth)
    with truth = [("DUP", "ctgA", pos), ("INV", "ctgA", pos), ("BND",
    "ctgA", pos, "ctgB", pos)]."""
    rng = random.Random(seed)
    L = contig_len
    ref1 = random_contig(rng, L)
    ref2 = random_contig(rng, L)
    h = 30_000
    recs1 = []
    recs2 = []

    # DUP at ctgA [40000,52000): contig crossing the copy junction
    d1, d2 = 40_000, 52_000
    seq = ref1[d2 - h:d2] + ref1[d1:d1 + h]
    recs1.append((d2 - h, encode_record(
        "dup.hap1", 0x0, 0, d2 - h, 60, [("M", h), ("S", h)],
        -1, -1, 0, seq)))
    recs1.append((d1, encode_record(
        "dup.hap1", 0x800, 0, d1, 60, [("S", h), ("M", h)],
        -1, -1, 0, seq)))

    # INV at ctgA [100000,140000): reverse-strand supplementary
    v1, v2 = 100_000, 140_000
    seq = ref1[v1 - h:v1] + revcomp(ref1[v2 - h:v2])
    recs1.append((v1 - h, encode_record(
        "inv.hap1", 0x0, 0, v1 - h, 60, [("M", h), ("S", h)],
        -1, -1, 0, seq)))
    recs1.append((v2 - h, encode_record(
        "inv.hap1", 0x810, 0, v2 - h, 60, [("M", h), ("S", h)],
        -1, -1, 0, revcomp(seq))))

    # BND ctgA:170000 -> ctgB:60000, in both samples
    ba, bb = 170_000, 60_000
    seq = ref1[ba - h:ba] + ref2[bb:bb + h]
    recs1.append((ba - h, encode_record(
        "bnd.hap1", 0x0, 0, ba - h, 60, [("M", h), ("S", h)],
        -1, -1, 0, seq)))
    recs2.append((bb, encode_record(
        "bnd.hap1", 0x800, 1, bb, 60, [("S", h), ("M", h)],
        -1, -1, 0, seq)))

    bam = f"{tmpdir}/{name}.bam"
    bam2 = f"{tmpdir}/{name}2.bam"
    fa = f"{tmpdir}/{name}.fa"
    allrecs = ([(0, p, b) for p, b in recs1]
               + [(1, p, b) for p, b in recs2])
    allrecs.sort(key=lambda r: (r[0], r[1]))
    write_bam(bam, [("ctgA", ref1), ("ctgB", ref2)],
              [r[2] for r in allrecs], sample="s1")
    bnd2 = [(0, ba - h, encode_record(
                "bnd.hap1", 0x0, 0, ba - h, 60, [("M", h), ("S", h)],
                -1, -1, 0, seq)),
            (1, bb, encode_record(
                "bnd.hap1", 0x800, 1, bb, 60, [("S", h), ("M", h)],
                -1, -1, 0, seq))]
    write_bam(bam2, [("ctgA", ref1), ("ctgB", ref2)],
              [r[2] for r in bnd2], sample="s2")
    write_fasta(fa, [("ctgA", ref1), ("ctgB", ref2)])
    return (bam, bam2), fa, [("DUP", "ctgA", d1), ("INV", "ctgA", v1),
                             ("BND", "ctgA", ba, "ctgB", bb)]

"""The port's copy of the dataset generators (delly_tpu_torch/testing/
synth.py) writes the same BAM, index and FASTA bytes, and the same
truth, as tests/bamsynth.py for the same seed and arguments. The asm
datasets are held to the constructions of bench_e2e.py's assembly run
and of tests/test_asm.py, rebuilt here from bamsynth's writers."""

import os
import random

import bamsynth
import pytest

from bamsynth import encode_record, random_contig, write_bam, write_fasta
from delly_tpu.utils.tags import revcomp
from delly_tpu_torch.testing import synth


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            out[name] = fh.read()
    return out


def _rel(obj, d):
    """The generator's return value with its directory taken out."""
    if isinstance(obj, str):
        return obj.replace(d, "<dir>")
    if isinstance(obj, (list, tuple)):
        return [_rel(x, d) for x in obj]
    return obj


def asm_indel(tmpdir, contig_len=1_500_000, name="asm"):
    """bench_e2e.py run_asm_bench's dataset."""
    rng = random.Random(7)
    L = contig_len
    ref = random_contig(rng, L)
    posd, dell = L // 3, 1200
    posi, insl = 2 * L // 3, 600
    ins_seq = random_contig(rng, insl)

    def hap(qname):
        cig = [("M", posd), ("D", dell),
               ("M", posi - (posd + dell)), ("I", insl),
               ("M", L - posi)]
        seq = ref[:posd] + ref[posd + dell:posi] + ins_seq + ref[posi:]
        return encode_record(qname, 0x0, 0, 0, 60, cig, -1, -1, 0, seq)

    write_bam(f"{tmpdir}/{name}.bam", [("chr1", ref)],
              [hap("h1"), hap("h2")])
    write_fasta(f"{tmpdir}/{name}.fa", [("chr1", ref)])
    return [("DEL", posd), ("INS", posi)]


def asm_diploid(tmpdir, contig_len=2_000_000, name="asm"):
    """tests/test_asm.py test_asm_diploid_genome_scale's dataset."""
    rng = random.Random(91)
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

    write_bam(f"{tmpdir}/{name}_h1.bam", [("chr1", ref)],
              [hap("s.hap1", True)])
    write_bam(f"{tmpdir}/{name}_h2.bam", [("chr1", ref)],
              [hap("s.hap2", False)])
    write_fasta(f"{tmpdir}/{name}.fa", [("chr1", ref)])
    return [("DEL", posd, "1/1"), ("INS", posi, "het")]


def asm_split(tmpdir, contig_len=200_000, name="asm"):
    """tests/test_asm.py test_asm_split_alignment_sv_families's
    dataset."""
    rng = random.Random(7)
    L = contig_len
    ref1 = random_contig(rng, L)
    ref2 = random_contig(rng, L)
    h = 30_000
    rec = []
    d1, d2 = 40_000, 52_000
    seq = ref1[d2 - h:d2] + ref1[d1:d1 + h]
    rec.append((0, d2 - h, encode_record(
        "dup.hap1", 0x0, 0, d2 - h, 60, [("M", h), ("S", h)], -1, -1, 0,
        seq)))
    rec.append((0, d1, encode_record(
        "dup.hap1", 0x800, 0, d1, 60, [("S", h), ("M", h)], -1, -1, 0,
        seq)))
    v1, v2 = 100_000, 140_000
    seq = ref1[v1 - h:v1] + revcomp(ref1[v2 - h:v2])
    rec.append((0, v1 - h, encode_record(
        "inv.hap1", 0x0, 0, v1 - h, 60, [("M", h), ("S", h)], -1, -1, 0,
        seq)))
    rec.append((0, v2 - h, encode_record(
        "inv.hap1", 0x810, 0, v2 - h, 60, [("M", h), ("S", h)], -1, -1, 0,
        revcomp(seq))))
    ba, bb = 170_000, 60_000
    seq = ref1[ba - h:ba] + ref2[bb:bb + h]
    bnd = [(0, ba - h, encode_record(
               "bnd.hap1", 0x0, 0, ba - h, 60, [("M", h), ("S", h)],
               -1, -1, 0, seq)),
           (1, bb, encode_record(
               "bnd.hap1", 0x800, 1, bb, 60, [("S", h), ("M", h)],
               -1, -1, 0, seq))]
    contigs = [("ctgA", ref1), ("ctgB", ref2)]
    allrecs = sorted(rec + bnd, key=lambda r: (r[0], r[1]))
    write_bam(f"{tmpdir}/{name}.bam", contigs, [r[2] for r in allrecs],
              sample="s1")
    write_bam(f"{tmpdir}/{name}2.bam", contigs, [r[2] for r in bnd],
              sample="s2")
    write_fasta(f"{tmpdir}/{name}.fa", contigs)
    return [("DUP", "ctgA", d1), ("INV", "ctgA", v1),
            ("BND", "ctgA", ba, "ctgB", bb)]


REFERENCE_BUILDERS = {"make_asm_indel_dataset": asm_indel,
                      "make_asm_diploid_dataset": asm_diploid,
                      "make_asm_split_dataset": asm_split}


@pytest.mark.parametrize("gen,kw", [
    ("make_multi_sv_dataset", dict(n_contigs=2, contig_len=60_000,
                                   pairs_per_contig=800, error_rate=0.01,
                                   name="ds")),
    ("make_deep_geno_dataset", dict(n_contigs=2, contig_len=50_000,
                                    dels_per_contig=6, coverage=6,
                                    name="ds")),
    ("make_lr_sv_dataset", dict(contig_len=140_000, bg_reads=20,
                                name="ds")),
    ("make_lr_genome_dataset", dict(n_contigs=2, contig_len=60_000,
                                    reads_per_contig=20, var_reads=4,
                                    error_rate=0.05, indel_error_rate=0.05,
                                    name="ds")),
    ("make_deep_lr_dataset", dict(n_contigs=2, contig_len=80_000,
                                  dels_per_contig=4, coverage=8,
                                  var_reads=3, name="ds")),
    ("make_multi_contig_del_dataset", dict(n_contigs=2, contig_len=60_000,
                                           pairs_per_contig=700,
                                           error_rate=0.01, name="ds")),
    ("make_population_cohort", dict(n_samples=3, n_contigs=2,
                                    contig_len=60_000, n_svs=4,
                                    pairs_per_contig=900, name="ds")),
    ("make_somatic_pair_dataset", dict(n_contigs=2, contig_len=40_000,
                                       pairs_per_contig=300)),
    ("make_asm_indel_dataset", dict(contig_len=60_000)),
    ("make_asm_diploid_dataset", dict(contig_len=90_000)),
    ("make_asm_split_dataset", dict()),
])
def test_same_bytes_as_bamsynth(tmp_path, gen, kw):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    if gen in REFERENCE_BUILDERS:
        ta = REFERENCE_BUILDERS[gen](str(a), **kw)
        tb = getattr(synth, gen)(str(b), **kw)[-1]
    else:
        ta = _rel(getattr(bamsynth, gen)(str(a), **kw), str(a))
        tb = _rel(getattr(synth, gen)(str(b), **kw), str(b))
    assert ta == tb
    fa, fb = _files(str(a)), _files(str(b))
    assert len(fa) >= 3 and fa == fb

"""The PyTorch port's `lr` slice end to end against the JAX package.

`delly_tpu_torch.cli lr` runs in a subprocess with
DELLY_TPU_TORCH_DEVICE=cpu (K1's plain version) and `delly_tpu.cli lr`
in another under JAX_PLATFORMS=cpu (tests/torch_card.py run_ok), on the
same inputs: the five SV families of `make_lr_sv_dataset` (whose consensus
distances reach queries of 8,192 rows, K1's widest), the msaWfa
insertion consensus, a noisy ONT-like genome, a deep long-read dataset
with `lr -v` on the JAX package's sites, MM/ML methylation, HP/PS
phasing written as BCF, and `-l` with an alternate alignment that is the
input itself. Each output (BCF decoded to text) must equal the JAX
package's apart from the ##fileDate line, exactly; the port's process
must end with neither jax nor any delly_tpu module imported, and with
no batch on the torch row-scan.
"""

import random
import struct

import pytest

from bamsynth import (aux_mm_ml, encode_record, make_deep_lr_dataset,
                      make_lr_genome_dataset, make_lr_insertion_dataset,
                      make_lr_sv_dataset, random_contig, write_bam,
                      write_fasta)
from torch_card import output_lines, run_ok, torch_cpu  # noqa: F401


def _phase_dataset(d):
    """HP/PS-tagged reads around one het DEL (tests/test_lr.py:180)."""
    rng = random.Random(13)
    clen = 120_000
    ref = random_contig(rng, clen)
    contigs = [("chrP1", ref)]
    del_len, posd, read_len = 1500, clen // 2, 6000

    def hp_ps(hp, ps):
        return b"HPC" + bytes([hp]) + b"PSi" + struct.pack("<i", ps)

    recs = []
    qid = 0
    for _ in range(12):
        p = posd - rng.randint(3000, 4500)
        recs.append((p, encode_record(
            f"r{qid}", 0x0, 0, p, 60, [("M", read_len)], -1, -1, 0,
            ref[p:p + read_len], aux=hp_ps(1, 77))))
        qid += 1
    for _ in range(10):
        lo, hi = rng.randint(1500, 2500), rng.randint(1500, 2500)
        p = posd - lo
        seq = ref[p:posd] + ref[posd + del_len:posd + del_len + hi]
        recs.append((p, encode_record(
            f"a{qid}", 0x0, 0, p, 60,
            [("M", lo), ("D", del_len), ("M", hi)], -1, -1, 0, seq,
            aux=hp_ps(2, 77))))
        qid += 1
    recs.sort(key=lambda r: r[0])
    bam, fa = f"{d}/phase.bam", f"{d}/phase.fa"
    write_bam(bam, contigs, [r[1] for r in recs])
    write_fasta(fa, contigs)
    return bam, fa, None


def _methyl_dataset(d):
    """MM/ML-tagged reads, ALT methylated and REF not, around one DEL
    (tests/test_junctions_methyl.py:145)."""
    rng = random.Random(7)
    clen = 120_000
    ref = random_contig(rng, clen)
    contigs = [("chrM1", ref)]
    del_len, posd, read_len = 1500, clen // 2, 6000

    def mm_for(seq, methylated):
        ncs = seq.upper().count("C")
        if ncs == 0:
            return b""
        mm = "C+m," + ",".join("0" for _ in range(ncs)) + ";"
        return aux_mm_ml(mm, [230 if methylated else 15] * ncs)

    recs = []
    qid = 0
    for _ in range(14):
        p = posd - rng.randint(3000, 4500)
        seq = ref[p:p + read_len]
        recs.append((p, encode_record(
            f"r{qid}", 0x0, 0, p, 60, [("M", read_len)], -1, -1, 0,
            seq, aux=mm_for(seq, False))))
        qid += 1
    for _ in range(12):
        lo, hi = rng.randint(1500, 2500), rng.randint(1500, 2500)
        p = posd - lo
        seq = ref[p:posd] + ref[posd + del_len:posd + del_len + hi]
        recs.append((p, encode_record(
            f"a{qid}", 0x0, 0, p, 60,
            [("M", lo), ("D", del_len), ("M", hi)], -1, -1, 0, seq,
            aux=mm_for(seq, True))))
        qid += 1
    recs.sort(key=lambda r: r[0])
    bam, fa = f"{d}/meth.bam", f"{d}/meth.fa"
    write_bam(bam, contigs, [r[1] for r in recs])
    write_fasta(fa, contigs)
    return bam, fa, None


DATASETS = {
    "lr_sv": make_lr_sv_dataset,
    "lr_ins": make_lr_insertion_dataset,
    "noisy": lambda d: make_lr_genome_dataset(
        d, n_contigs=1, contig_len=200_000, reads_per_contig=60,
        var_reads=12, error_rate=0.05, indel_error_rate=0.05, name="noisy"),
    "deep_lr": lambda d: make_deep_lr_dataset(
        d, n_contigs=1, contig_len=120_000, dels_per_contig=10,
        coverage=20),
    "methyl": _methyl_dataset,
    "phase": _phase_dataset,
}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_lr")


# (case, dataset, output suffix, extra options)
CASES = [
    ("lr_sv", "lr_sv", "vcf", []),
    ("lr_ins", "lr_ins", "vcf", []),
    ("noisy", "noisy", "vcf", []),
    ("deep_lr", "deep_lr", "vcf", []),
    ("deep_lr -v", "deep_lr", "vcf", ["-v"]),
    ("methyl", "methyl", "vcf", []),
    ("phase bcf", "phase", "bcf", []),
    ("lr_sv -l", "lr_sv", "vcf", ["-l"]),
]


@pytest.mark.parametrize("case,name,suffix,extra", CASES,
                         ids=[c[0] for c in CASES])
def test_lr_matches_jax(workdir, case, name, suffix, extra):
    d = workdir / name
    if not d.exists():
        d.mkdir()
        DATASETS[name](str(d))
    bam = str(next(d.glob("*.bam")))
    fa = str(next(d.glob("*.fa")))
    stem = case.replace(" ", "_").replace("-", "")
    jsteps, opts = [], []
    if "-v" in extra:
        sites = str(d / "sites.vcf")
        jsteps.append(["lr", "-g", fa, "-o", sites, bam])
        opts = ["-v", sites]
    if "-l" in extra:
        alt = d / "alt.tsv"
        alt.write_text(f"{bam}\t{fa}\n")
        opts = ["-l", str(alt)]
    want = str(d / f"{stem}.jax.{suffix}")
    got = str(d / f"{stem}.port.{suffix}")
    jerr = run_ok("delly_tpu", jsteps + [["lr", *opts, "-g", fa, "-o", want,
                                           bam]], d)["stderr"]
    perr = run_ok("delly_tpu_torch", [["lr", *opts, "-g", fa, "-o", got,
                                        bam]], d)["stderr"]
    body = output_lines(got)
    assert body == output_lines(want)
    assert any(not ln.startswith("#") for ln in body)
    if "-l" in extra:
        assert "Filtered 0 out of" in jerr and "Filtered 0 out of" in perr


@pytest.mark.parametrize("argv", [
    [],
    ["-y", "pb", "-t", "DEL,INS", "-q", "5", "-a", "0.85", "--extension",
     "0.7", "--read-cap", "30", "-b", "100", "--pruning", "500"],
])
def test_lr_options_match_jax(tmp_path, monkeypatch, torch_cpu, argv):
    """The port's `lr` word takes every option of the JAX package's, with
    the same defaults and the same LrConfig, --extension rounded through
    float32 included."""
    import argparse

    import delly_tpu.cli as jcli
    import delly_tpu.models.lr as jlr
    import delly_tpu_torch.cli as pcli
    import delly_tpu_torch.models.lr as plr

    fa, bam = str(tmp_path / "r.fa"), str(tmp_path / "r.bam")
    ref = random_contig(random.Random(1), 2000)
    write_fasta(fa, [("c1", ref)])
    write_bam(bam, [("c1", ref)], [encode_record(
        "r0", 0, 0, 10, 60, [("M", 100)], -1, -1, 0, ref[10:110])])
    cfgs = []
    for cli, lr in ((jcli, jlr), (pcli, plr)):
        parser = argparse.ArgumentParser()
        sub = parser.add_subparsers(dest="command")
        cli._add_lr(sub)
        args = parser.parse_args(["lr", *argv, "-g", fa, "-o", "x.vcf", bam])
        monkeypatch.setattr(lr, "run_lr", lambda cfg: cfgs.append(cfg) or 0)
        run = getattr(cli, "_run_command_inner", cli._run_command)
        assert run(args) == 0
    assert len(cfgs) == 2 and vars(cfgs[0]) == vars(cfgs[1])

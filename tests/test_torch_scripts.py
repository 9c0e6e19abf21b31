"""The port's copies of the helper scripts, delly_tpu_torch.scripts
delly2bnd and mergegeno, against the originals in scripts/: on the same
inputs, made by the port's `sr` on the CPU from generated data, each
module writes the same bytes as its original, both run in a subprocess
from the repository's root."""

import os
import random
import shutil
import subprocess
import sys

import pytest

from delly_tpu_torch.testing.synth import (encode_record,
                                           make_deep_geno_dataset,
                                           write_bam, write_fasta)
from torch_card import output_lines, run_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _translocation_dataset(tmpdir, seed=11):
    """Two contigs with a reciprocal translocation junction
    ctgA:12000(3') -> ctgB:6000(5'): normal pairs for library stats,
    discordant cross-contig pairs and split reads over the junction
    (the construction of tests/test_workflow.py's translocation test,
    through the port's BAM writer)."""
    rng = random.Random(seed)
    ctga = "".join(rng.choice("ACGT") for _ in range(20000))
    ctgb = "".join(rng.choice("ACGT") for _ in range(20000))
    contigs = [("ctgA", ctga), ("ctgB", ctgb)]
    bp_a, bp_b = 12000, 6000
    derived = ctga[:bp_a] + ctgb[bp_b:]
    rl, isize = 100, 400
    recs = []

    def pair(qid, tid, ref, p1):
        p2 = p1 + isize - rl
        recs.append((tid, p1, encode_record(
            f"p{qid}", 0x63, tid, p1, 60, [("M", rl)], tid, p2, isize,
            ref[p1:p1 + rl])))
        recs.append((tid, p2, encode_record(
            f"p{qid}", 0x93, tid, p2, 60, [("M", rl)], tid, p1, -isize,
            ref[p2:p2 + rl])))

    qid = 0
    for _ in range(700):
        pair(qid, 0, ctga, rng.randint(0, len(ctga) - isize - 1))
        qid += 1
    for _ in range(700):
        pair(qid, 1, ctgb, rng.randint(0, len(ctgb) - isize - 1))
        qid += 1
    for _ in range(40):
        off = rng.randint(60, 250)
        p1 = bp_a - off - rl
        p2 = bp_b + (isize - off - 2 * rl) + rng.randint(0, 30)
        recs.append((0, p1, encode_record(
            f"t{qid}", 0x61, 0, p1, 60, [("M", rl)], 1, p2, 0,
            ctga[p1:p1 + rl])))
        recs.append((1, p2, encode_record(
            f"t{qid}", 0x91, 1, p2, 60, [("M", rl)], 0, p1, 0,
            ctgb[p2:p2 + rl])))
        qid += 1
    for _ in range(30):
        off = rng.randint(25, 70)
        dpos = bp_a - off
        seq = derived[dpos:dpos + rl]
        recs.append((0, dpos, encode_record(
            f"s{qid}", 0x0, 0, dpos, 60, [("M", off), ("S", rl - off)],
            -1, -1, 0, seq)))
        recs.append((1, bp_b, encode_record(
            f"s{qid}", 0x800, 1, bp_b, 60,
            [("S", off), ("M", rl - off)], -1, -1, 0, seq)))
        qid += 1
    recs.sort(key=lambda r: (r[0], r[1]))
    bam, fa = f"{tmpdir}/tra.bam", f"{tmpdir}/tra.fa"
    write_bam(bam, contigs, [r[2] for r in recs])
    write_fasta(fa, contigs)
    return bam, fa


def _both(name, args):
    """Runs scripts/<name>.py and delly_tpu_torch.scripts.<name> on the
    same arguments, each writing the output named by the argument that
    holds "{}" (with "orig" and "port" in its place): the two outputs'
    bytes."""
    (at,) = [i for i, a in enumerate(args) if "{}" in a]
    out = []
    for tag, cmd in (("orig", [os.path.join("scripts", f"{name}.py")]),
                     ("port", ["-m", f"delly_tpu_torch.scripts.{name}"])):
        argv = [a.replace("{}", tag) for a in args]
        r = subprocess.run([sys.executable, *cmd, *argv], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, (tag, r.stderr[-1500:])
        with open(argv[at], "rb") as fh:
            out.append(fh.read())
    return out


def test_delly2bnd_matches_script(tmp_path):
    bam, fa = _translocation_dataset(str(tmp_path))
    calls = str(tmp_path / "tra.vcf")
    run_port([["sr", "-g", fa, "-o", calls, bam]], tmp_path, timeout=600)
    recs = [ln for ln in output_lines(calls) if not ln.startswith("#")]
    assert len(recs) == 1 and "SVTYPE=BND" in recs[0]
    orig, port = _both("delly2bnd", ["-v", calls, "-r", fa, "-o",
                                     str(tmp_path / "bnd.{}.vcf")])
    assert port == orig
    bnd = [ln for ln in port.decode().splitlines()
           if not ln.startswith("#")]
    assert len(bnd) == 2
    ids = [ln.split("\t")[2] for ln in bnd]
    mates = [ln.split("MATEID=")[1].split(";")[0].split("\t")[0]
             for ln in bnd]
    assert ids == mates[::-1]


@pytest.mark.parametrize("ext", ["vcf", "bcf"])
def test_mergegeno_matches_script(tmp_path, ext):
    bam, fa, _truth = make_deep_geno_dataset(
        str(tmp_path), n_contigs=1, contig_len=100_000, dels_per_contig=5,
        coverage=10)
    s2 = str(tmp_path / "s2.bam")
    shutil.copy(bam, s2)
    p = lambda name: str(tmp_path / name)  # noqa: E731
    steps = [["sr", "-g", fa, "-o", p("s1.bcf"), bam],
             ["sr", "-g", fa, "-o", p("s2.bcf"), s2],
             ["merge", "-o", p("sites.bcf"), p("s1.bcf"), p("s2.bcf")]]
    steps += [["sr", "-g", fa, "-v", p("sites.bcf"), "-o", p(f"g{i}.bcf"),
               b] for i, b in enumerate((bam, s2))]
    out = run_port(steps, tmp_path, timeout=600)
    assert out["rcs"] == [0] * len(steps), out["stderr"][-1500:]
    orig, port = _both("mergegeno", ["-o", p(f"multi.{{}}.{ext}"),
                                     p("g0.bcf"), p("g1.bcf")])
    assert port == orig
    recs = [ln.split("\t") for ln in output_lines(p(f"multi.port.{ext}"))
            if not ln.startswith("#")]
    assert recs and all(len(r) == 11 for r in recs)

"""The PyTorch port's `asm` word against the JAX package.

`asm` runs through both CLIs on the CPU (tests/torch_card.py run_both:
`delly_tpu.cli` under JAX_PLATFORMS=cpu, `delly_tpu_torch.cli` with
DELLY_TPU_TORCH_DEVICE=cpu) on the assembly datasets of
delly_tpu_torch/testing/synth.py (held to the constructions of
bench_e2e.py and tests/test_asm.py by tests/test_torch_synth.py):

- squashed: a DEL and an INS as CIGAR indels in two 200 kb alignments
  (bench_e2e.py's assembly run, cut from 1.5 Mb), also with `-t DEL`;
- diploid: a homozygous DEL and a hap1-only INS over 300 kb (`-y
  diploid`; tests/test_asm.py builds it over 2 Mb);
- the split-alignment DUP, INV and BND of tests/test_asm.py over two
  samples, whose consensus check sends K1 queries of 8,192 rows.

Each VCF must equal the JAX package's apart from the ##fileDate line,
exactly, and meet its truth; the port's process must end with neither
jax nor any delly_tpu module imported, and with no torch row-scan batch.
"""

import pytest

from delly_tpu_torch.testing.synth import (make_asm_diploid_dataset,
                                           make_asm_indel_dataset,
                                           make_asm_split_dataset)
from torch_card import check_case, run_both


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_asm")
    sq = make_asm_indel_dataset(str(d), contig_len=200_000, name="sq")
    dip = make_asm_diploid_dataset(str(d), contig_len=300_000, name="dip")
    fam = make_asm_split_dataset(str(d), name="fam")

    def cases(_src, dst):
        return {
            "squashed": [["asm", "-g", sq[1], "-o", f"{d}/sq.{dst}.vcf",
                          sq[0]]],
            "squashed -t DEL": [["asm", "-t", "DEL", "-g", sq[1], "-o",
                                 f"{d}/sqdel.{dst}.vcf", sq[0]]],
            "diploid": [["asm", "-y", "diploid", "-g", dip[1], "-o",
                         f"{d}/dip.{dst}.vcf", *dip[0]]],
            "families": [["asm", "-g", fam[1], "-o", f"{d}/fam.{dst}.vcf",
                          *fam[0]]],
        }

    result, port = run_both(cases, d)
    truth = {"squashed": sq[2], "squashed -t DEL": sq[2][:1],
             "diploid": dip[2], "families": fam[2]}
    return result, port, truth


def _calls(records):
    out = []
    for rec in records:
        f = rec.split("\t")
        svt = [kv for kv in f[7].split(";") if kv.startswith("SVTYPE=")]
        out.append((svt[0][7:], f[0], int(f[1]), f[9].split(":")[0]))
    return out


@pytest.mark.parametrize("case", ["squashed", "squashed -t DEL"])
def test_asm_squashed_matches_jax(runs, case):
    result, port, truth = runs
    (records,) = check_case(result, port, case)
    calls = _calls(records)
    assert len(calls) == len(truth[case])
    for svt, pos in truth[case]:
        assert any(s == svt and abs(p - pos) < 50 for s, _c, p, _g in calls)


def test_asm_diploid_matches_jax(runs):
    """The homozygous DEL unphased 1/1, the hap1-only INS phased."""
    result, port, truth = runs
    (records,) = check_case(result, port, "diploid")
    calls = {s: (p, g) for s, _c, p, g in _calls(records)}
    assert len(records) == 2
    (_, dpos, _), (_, ipos, _) = truth["diploid"]
    assert abs(calls["DEL"][0] - dpos) < 50 and calls["DEL"][1] == "1/1"
    assert abs(calls["INS"][0] - ipos) < 50
    assert calls["INS"][1] in ("1|0", "0|1")


def test_asm_split_families_match_jax(runs):
    result, port, truth = runs
    (records,) = check_case(result, port, "families")
    calls = _calls(records)
    for svt, *ends in truth["families"]:
        # a BND may be written at either of its two ends
        assert any(s == svt and c == chrom and abs(p - pos) < 100
                   for s, c, p, _g in calls
                   for chrom, pos in zip(ends[::2], ends[1::2])), (svt, calls)

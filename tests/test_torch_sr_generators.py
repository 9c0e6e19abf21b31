"""The PyTorch port's `sr` against the JAX package on every short-read
generator of tests/bamsynth.py.

`sr` runs through both CLIs on the CPU (tests/torch_card.py run_both:
`delly_tpu.cli` under JAX_PLATFORMS=cpu, `delly_tpu_torch.cli` with
DELLY_TPU_TORCH_DEVICE=cpu) on the translocation, PE-only DUP and INV,
novel insertion, multi-contig DEL, four BND orientations, overlapping
DELs and homopolymer DEL datasets; on the multi-contig DELs also as a
two-sample run written as BCF; and on a mixed-SV dataset with `-t DEL`
and with an `-x` exclude file. Each output (BCF decoded to text) must
equal the JAX package's apart from the ##fileDate line, exactly; the
port's process must end with neither jax nor any delly_tpu module
imported, and with no torch row-scan batch.
"""

import shutil

import pytest

import bamsynth
from torch_card import check_case, run_both

GENERATORS = ["make_translocation_dataset", "make_dup_inv_dataset",
              "make_insertion_dataset", "make_multi_contig_del_dataset",
              "make_bnd_orientation_dataset",
              "make_overlapping_dels_dataset",
              "make_homopolymer_del_dataset"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sr_generators")
    data = {g: getattr(bamsynth, g)(str(d))[:2] for g in GENERATORS}
    mbam, mfa = data["make_multi_contig_del_dataset"]
    mbam2 = str(d / "multi2.bam")
    shutil.copy(mbam, mbam2)
    shutil.copy(mbam + ".bai", mbam2 + ".bai")
    sbam, sfa, _ = bamsynth.make_multi_sv_dataset(
        str(d), n_contigs=1, contig_len=100_000, pairs_per_contig=1500,
        name="svmix")
    excl = d / "excl.bed"
    excl.write_text("chr1\t10000\t30000\n")

    def cases(_src, dst):
        out = {g: [["sr", "-g", fa, "-o", f"{d}/{g}.{dst}.vcf", bam]]
               for g, (bam, fa) in data.items()}
        out["two samples, bcf"] = [["sr", "-g", mfa, "-o",
                                    f"{d}/two.{dst}.bcf", mbam, mbam2]]
        out["-t DEL"] = [["sr", "-t", "DEL", "-g", sfa, "-o",
                          f"{d}/del.{dst}.vcf", sbam]]
        out["-x"] = [["sr", "-x", str(excl), "-g", sfa, "-o",
                      f"{d}/excl.{dst}.vcf", sbam]]
        return out

    return run_both(cases, d)


@pytest.mark.parametrize("case", GENERATORS + ["two samples, bcf",
                                               "-t DEL", "-x"])
def test_sr_matches_jax(runs, case):
    (records,) = check_case(*runs, case)
    assert records
    if case == "-t DEL":
        assert all("SVTYPE=DEL;" in r for r in records)
    if case == "two samples, bcf":
        assert all(len(r.split("\t")) == 11 for r in records)

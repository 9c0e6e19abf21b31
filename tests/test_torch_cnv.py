"""The PyTorch port's `cnv` word against the JAX package.

`cnv` runs through both CLIs on the CPU (tests/torch_card.py run_both:
`delly_tpu.cli` under JAX_PLATFORMS=cpu, `delly_tpu_torch.cli` with
DELLY_TPU_TORCH_DEVICE=cpu) on `make_multi_contig_del_dataset`'s two
contigs, each with a het 8 kb DEL and a homozygous read-depth hole:

- `cnv` with the coverage (`-c`), segmentation (`-u`) and statistics
  files;
- the CNV cohort of tests/test_workflow.py: `cnv` of two samples, `merge
  -e -y 0`, then `cnv -v` on the merged sites (each port step on the JAX
  package's output of the step before);
- `cnv --basecov` (base coverage) and `cnv --fragmentcov` (fragment
  coverage).

Every output must equal the JAX package's apart from the ##fileDate
line, exactly: BCF decoded to text and gzip files decompressed (the
gzip header holds its write time). The port's process must end with
neither jax nor any delly_tpu module imported.
"""

import shutil

import pytest

from bamsynth import make_multi_contig_del_dataset
from torch_card import check_case, output_lines, run_both


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cnv")
    bam, fa, _ = make_multi_contig_del_dataset(
        str(d), n_contigs=2, contig_len=120_000, pairs_per_contig=2500,
        name="cc1")
    bam2 = str(d / "cc2.bam")
    shutil.copy(bam, bam2)
    shutil.copy(bam + ".bai", bam2 + ".bai")

    def cases(src, dst):
        def o(name):
            return f"{d}/{name}.{dst}"

        def i(name):
            return f"{d}/{name}.{src}"

        return {
            "-c -u": [["cnv", "-g", fa, "-c", o("cov.gz"), "-u", o("seg.gz"),
                       "--statsfile", o("stats.gz"), "-o", o("cnv.bcf"),
                       bam]],
            "cohort": [["cnv", "-g", fa, "-o", o("cnv1.bcf"), bam],
                       ["cnv", "-g", fa, "-o", o("cnv2.bcf"), bam2],
                       ["merge", "-e", "-y", "0", "-o", o("sites.bcf"),
                        i("cnv1.bcf"), i("cnv2.bcf")],
                       ["cnv", "-g", fa, "-v", i("sites.bcf"), "-o",
                        o("geno.bcf"), bam]],
            "--basecov": [["cnv", "--basecov", "-g", fa, "-o",
                           o("base.bcf"), bam]],
            "--fragmentcov": [["cnv", "--fragmentcov", "-g", fa, "-o",
                               o("frag.bcf"), bam]],
        }

    return (*run_both(cases, d), d)


def test_cnv_files_match_jax(runs):
    """The VCF, and the -c, -u and --statsfile outputs beside it."""
    result, port, d = runs
    (records,) = check_case(result, port, "-c -u")
    assert records
    for name in ("cov.gz", "seg.gz", "stats.gz"):
        lines = output_lines(f"{d}/{name}.jax")
        assert lines and output_lines(f"{d}/{name}.port") == lines, name


def test_cnv_cohort_matches_jax(runs):
    """Per-sample discovery, `merge -e`, then `cnv -v`: every merged site
    re-genotyped with a read-depth copy number."""
    cnv1, cnv2, sites, geno = check_case(*runs[:2], "cohort")
    assert cnv1 and cnv1 == cnv2
    assert sites and len(geno) == len(sites)
    for rec in geno:
        f = rec.split("\t")
        fmt = dict(zip(f[8].split(":"), f[9].split(":")))
        assert fmt.get("RDCN") not in (None, "")


@pytest.mark.parametrize("case", ["--basecov", "--fragmentcov"])
def test_cnv_coverage_modes_match_jax(runs, case):
    (records,) = check_case(*runs[:2], case)
    assert records

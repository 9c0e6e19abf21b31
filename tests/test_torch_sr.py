"""The PyTorch port's `sr` slice end to end against the JAX package.

`python -m delly_tpu_torch.cli sr` runs in a subprocess with
DELLY_TPU_TORCH_DEVICE=cpu (the kernels' plain versions) on a small
mixed-SV dataset and a small deep-genotyping dataset, and `sr -v`
re-genotypes the deep dataset's sites. Each VCF must equal the one from
`python -m delly_tpu.cli` apart from the ##fileDate line, and the port's
process must end with neither jax nor any delly_tpu module imported,
and with no torch row-scan batch (tests/torch_card.py run_port).
"""

import pytest

from bamsynth import make_deep_geno_dataset, make_multi_sv_dataset
from torch_card import output_lines, run_ok


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sr")
    sv = make_multi_sv_dataset(str(d), n_contigs=2, contig_len=200_000,
                               pairs_per_contig=3000)
    dg = make_deep_geno_dataset(str(d), n_contigs=1, contig_len=120_000,
                                dels_per_contig=20, coverage=20)
    return d, {"svmix": sv, "deepgeno": dg}


@pytest.mark.parametrize("name", ["svmix", "deepgeno"])
def test_sr_discovery_matches_jax(datasets, name):
    d, sets = datasets
    bam, fa, truth = sets[name]
    want, got = str(d / f"{name}.jax.vcf"), str(d / f"{name}.port.vcf")
    run_ok("delly_tpu", [["sr", "-g", fa, "-o", want, bam]], d)
    run_ok("delly_tpu_torch", [["sr", "-g", fa, "-o", got, bam]], d)
    body = output_lines(got)
    assert body == output_lines(want)
    assert sum(not ln.startswith("#") for ln in body) >= len(truth)


def test_sr_regenotype_matches_jax(datasets):
    d, sets = datasets
    bam, fa, _truth = sets["deepgeno"]
    sites = str(d / "sites.vcf")
    want, got = str(d / "regeno.jax.vcf"), str(d / "regeno.port.vcf")
    run_ok("delly_tpu", [["sr", "-g", fa, "-o", sites, bam],
                         ["sr", "-v", sites, "-g", fa, "-o", want, bam]], d)
    run_ok("delly_tpu_torch", [["sr", "-v", sites, "-g", fa, "-o", got, bam]],
           d)
    assert output_lines(got) == output_lines(want)

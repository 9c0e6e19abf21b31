"""The port's copy of the dataset generators (delly_tpu_torch/testing/
synth.py) writes the same BAM, index and FASTA bytes, and the same
truth, as tests/bamsynth.py for the same seed and arguments."""

import os

import bamsynth
import pytest

from delly_tpu_torch.testing import synth


def _files(d, name):
    out = {}
    for ext in (".bam", ".bam.bai", ".fa", ".fa.fai"):
        with open(os.path.join(d, name + ext), "rb") as fh:
            out[ext] = fh.read()
    return out


@pytest.mark.parametrize("gen,kw", [
    ("make_multi_sv_dataset", dict(n_contigs=2, contig_len=60_000,
                                   pairs_per_contig=800, error_rate=0.01)),
    ("make_deep_geno_dataset", dict(n_contigs=2, contig_len=50_000,
                                    dels_per_contig=6, coverage=6)),
    ("make_lr_sv_dataset", dict(contig_len=140_000, bg_reads=20)),
    ("make_lr_genome_dataset", dict(n_contigs=2, contig_len=60_000,
                                    reads_per_contig=20, var_reads=4,
                                    error_rate=0.05, indel_error_rate=0.05)),
    ("make_deep_lr_dataset", dict(n_contigs=2, contig_len=80_000,
                                  dels_per_contig=4, coverage=8,
                                  var_reads=3)),
])
def test_same_bytes_as_bamsynth(tmp_path, gen, kw):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    ta = getattr(bamsynth, gen)(str(a), name="ds", **kw)[2]
    tb = getattr(synth, gen)(str(b), name="ds", **kw)[2]
    assert ta == tb
    assert _files(str(a), "ds") == _files(str(b), "ds")

"""The PyTorch port's `merge` and `filter` words against the JAX package.

Every step runs through both CLIs on the CPU: `delly_tpu.cli` under
JAX_PLATFORMS=cpu, `delly_tpu_torch.cli` with DELLY_TPU_TORCH_DEVICE=cpu
(tests/torch_card.py run_cli: one process per package for all steps).
Each port step reads the JAX package's output of the step before, so a
difference points at one command. The workflows:

- germline: per-sample `sr` of a small population cohort, `merge`, one
  joint `sr -v` over all BAMs, `filter -f germline`;
- somatic: a joint tumor + control `sr`, `filter -f somatic -s`;
- `merge` options: `-u 100` over 130 inputs (chunked merging), a file
  list, `-c`, `-p`, `-b`, `-r`, and `-e -y 0` (also with `-q 2`) over
  two `cnv` BCFs;
- the inline VCFs of tests/test_merge_filter.py (merge, germline,
  somatic, a zero-coverage control, samples with missing GTs).

Each output (BCF decoded to text) must equal the JAX package's apart
from the ##fileDate line, exactly; the port's process must end with
neither jax nor any delly_tpu module imported.
"""

import shutil

import pytest

from bamsynth import (make_multi_contig_del_dataset, make_population_cohort,
                      make_somatic_pair_dataset)
from torch_card import check_case, run_both, run_cli

HDR_MERGE = [
    "##fileformat=VCFv4.2",
    "##contig=<ID=18,length=200001>",
    '##INFO=<ID=END,Number=1,Type=Integer,Description="E">',
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="T">',
    '##INFO=<ID=CT,Number=1,Type=String,Description="C">',
    '##INFO=<ID=PE,Number=1,Type=Integer,Description="P">',
    '##INFO=<ID=SR,Number=1,Type=Integer,Description="S">',
    '##INFO=<ID=SRMAPQ,Number=1,Type=Integer,Description="Q">',
    '##INFO=<ID=SRQ,Number=1,Type=Float,Description="Q">',
    '##INFO=<ID=CE,Number=1,Type=Float,Description="Q">',
    '##INFO=<ID=PRECISE,Number=0,Type=Flag,Description="P">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
    '##FORMAT=<ID=RR,Number=1,Type=Integer,Description="G">',
    '##FORMAT=<ID=RV,Number=1,Type=Integer,Description="G">',
]
HDR_FILTER = [
    "##fileformat=VCFv4.2",
    "##contig=<ID=18,length=200001>",
    '##INFO=<ID=END,Number=1,Type=Integer,Description="E">',
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="T">',
    '##INFO=<ID=PRECISE,Number=0,Type=Flag,Description="P">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
]
FMT = ['##FORMAT=<ID=%s,Number=%s,Type=Integer,Description="G">' % kv
       for kv in (("GQ", "1"), ("PL", "G"), ("RC", "1"), ("RCL", "1"),
                  ("RCR", "1"), ("RR", "1"), ("RV", "1"), ("DR", "1"),
                  ("DV", "1"))]
COLS = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
DEL_INFO = ("PRECISE;SVTYPE=DEL;CT=3to5;END={end};PE=5;SR=6;SRMAPQ=60;"
            "SRQ=0.95;CE=1.8")


def _write_inline_vcfs(d):
    """tests/test_merge_filter.py's call sets, and two with missing GTs
    (its collect_svtype cases) as files."""
    rec = "18\t{pos}\tDEL1\tG\t<DEL>\t900\tPASS\t" + DEL_INFO + \
        "\tGT:RR:RV\t0/1:10:9"
    for i, (pos, end) in enumerate(((100000, 108002), (100005, 108000))):
        (d / f"m{i + 1}.vcf").write_text("\n".join(
            HDR_MERGE + [COLS + f"S{i + 1}",
                         rec.format(pos=pos, end=end)]) + "\n")
    het = "0/1:90:500,0,500:500:1000:1000:10:10:10:10"
    ref = "0/0:90:0,500,990:1000:1000:1000:20:0:20:0"
    (d / "germ.vcf").write_text("\n".join(
        HDR_FILTER + FMT
        + [COLS + "\t".join(f"S{i}" for i in range(8)),
           "18\t100000\tDEL1\tG\t<DEL>\t900\tPASS\tPRECISE;SVTYPE=DEL;"
           "END=108002\tGT:GQ:PL:RC:RCL:RCR:RR:RV:DR:DV\t"
           + "\t".join(het if i < 3 else ref for i in range(8))]) + "\n")
    pair_hdr = HDR_FILTER + [FMT[i] for i in (2, 5, 6, 7, 8)] + [
        COLS + "tum\tctl"]
    pair = ("18\t100000\tDEL1\tG\t<DEL>\t900\tPASS\tPRECISE;SVTYPE=DEL;"
            "END=108002\tGT:RC:RR:RV:DR:DV\t0/1:500:10:10:10:10\t{ctl}")
    (d / "pair.vcf").write_text("\n".join(
        pair_hdr + [pair.format(ctl="0/0:1000:20:0:20:0")]) + "\n")
    (d / "pair0.vcf").write_text("\n".join(
        pair_hdr + [pair.format(ctl="0/0:1000:0:0:0:0")]) + "\n")
    (d / "pair.tsv").write_text("tum\ttumor\nctl\tcontrol\n")
    # a het sample beside one whose GT is missing, and a record whose
    # every GT is missing (merge.h:484-487: no carrier, no VAF route)
    miss = ["18\t100000\tDEL1\tG\t<DEL>\t300\tPASS\t" + DEL_INFO.format(
                end=100500) + "\tGT:RR:RV\t0/1:10:10\t.:5:15",
            "18\t150000\tDEL2\tG\t<DEL>\t300\tPASS\t" + DEL_INFO.format(
                end=150500) + "\tGT:RR:RV\t.:5:15\t./.:4:16"]
    for i in (1, 2):
        (d / f"miss{i}.vcf").write_text("\n".join(
            HDR_MERGE + [COLS + f"a{i}\tb{i}"] + miss) + "\n")


class Workflows:
    """The steps of every case, for outputs tagged `dst` from inputs
    tagged `src` ("jax" for the JAX package's outputs)."""

    def __init__(self, d):
        self.d = d
        self.bams, self.fa, _ = make_population_cohort(
            str(d), n_samples=4, n_contigs=2, contig_len=100_000, n_svs=6,
            pairs_per_contig=6_000)
        self.tumor, self.control, self.sfa, self.germ, self.soma = \
            make_somatic_pair_dataset(str(d))
        (d / "samples.tsv").write_text("tumor\ttumor\ncontrol\tcontrol\n")
        self.cbam, self.cfa, _ = make_multi_contig_del_dataset(
            str(d), n_contigs=2, contig_len=120_000, pairs_per_contig=2500,
            name="cc1")
        self.cbam2 = str(d / "cc2.bam")
        shutil.copy(self.cbam, self.cbam2)
        shutil.copy(self.cbam + ".bai", self.cbam2 + ".bai")
        _write_inline_vcfs(d)

    def p(self, name, tag):
        return str(self.d / f"{name}.{tag}")

    def samples(self, tag):
        """Per-sample `sr` BCFs and the cnv BCFs: the inputs of merge."""
        return [self.p(f"s{i}", f"{tag}.bcf") for i in range(len(self.bams))]

    def discovery(self, dst):
        """Per-sample sr of the cohort, and cnv of the two CNV samples."""
        steps = [["sr", "-g", self.fa, "-o", out, bam]
                 for out, bam in zip(self.samples(dst), self.bams)]
        steps += [["cnv", "-g", self.cfa, "-o",
                   self.p(f"cnv{i}", f"{dst}.bcf"), bam]
                  for i, bam in enumerate((self.cbam, self.cbam2))]
        return steps

    def cases(self, src, dst):
        """{case: [argv, ...]}; "discovery" first."""
        p, s = self.p, self.samples(src)
        chunked = [str(self.d / f"c{i}.bcf") for i in range(130)]
        return {
            "discovery": self.discovery(dst),
            "germline": [
                ["merge", "-o", p("sites", f"{dst}.bcf"), *s],
                ["sr", "-v", p("sites", f"{src}.bcf"), "-g", self.fa, "-o",
                 p("geno", f"{dst}.bcf"), *self.bams],
                ["filter", "-f", "germline", "-o", p("germ", f"{dst}.bcf"),
                 p("geno", f"{src}.bcf")]],
            "somatic": [
                ["sr", "-g", self.sfa, "-o", p("joint", f"{dst}.bcf"),
                 self.tumor, self.control],
                ["filter", "-f", "somatic", "-s", str(self.d / "samples.tsv"),
                 "-o", p("som", f"{dst}.bcf"), p("joint", f"{src}.bcf")]],
            "-u 100 chunked": [["merge", "-u", "100", "-o",
                                p("chunked", f"{dst}.bcf"), *chunked]],
            "file list": [["merge", "-o", p("list", f"{dst}.bcf"),
                           str(self.d / "files.txt")]],
            "-c": [["merge", "-c", "-o", p("prec", f"{dst}.bcf"), *s]],
            "-p": [["merge", "-p", "-o", p("pass", f"{dst}.bcf"), *s]],
            "-b 100": [["merge", "-b", "100", "-o", p("bp", f"{dst}.bcf"),
                        *s]],
            "-r 0.5": [["merge", "-r", "0.5", "-o", p("ro", f"{dst}.bcf"),
                        *s]],
            "-e -y 0 cnv": [["merge", "-e", "-y", "0", "-o",
                             p("cnvsites", f"{dst}.bcf"),
                             p("cnv0", f"{src}.bcf"),
                             p("cnv1", f"{src}.bcf")]],
            "-e -y 0 -q 2 cnv": [["merge", "-e", "-y", "0", "-q", "2", "-o",
                                  p("cnvsites2", f"{dst}.bcf"),
                                  p("cnv0", f"{src}.bcf"),
                                  p("cnv1", f"{src}.bcf")]],
            "merge vcf": [["merge", "-o", p("merged", f"{dst}.vcf"),
                           str(self.d / "m1.vcf"), str(self.d / "m2.vcf")]],
            "germline vcf": [["filter", "-f", "germline", "-o",
                              p("germf", f"{dst}.vcf"),
                              str(self.d / "germ.vcf")]],
            "somatic vcf": [["filter", "-f", "somatic", "-s",
                             str(self.d / "pair.tsv"), "-o",
                             p("somf", f"{dst}.vcf"),
                             str(self.d / "pair.vcf")]],
            "zero-coverage control": [["filter", "-f", "somatic", "-s",
                                       str(self.d / "pair.tsv"), "-o",
                                       p("som0", f"{dst}.vcf"),
                                       str(self.d / "pair0.vcf")]],
            "missing GT": [["merge", "-o", p("miss", f"{dst}.vcf"),
                            str(self.d / "miss1.vcf"),
                            str(self.d / "miss2.vcf")]],
        }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's discovery (the inputs of merge), then every case
    through the JAX package and through the port."""
    d = tmp_path_factory.mktemp("torch_merge_filter")
    wf = Workflows(d)
    first = run_cli("delly_tpu", wf.discovery("jax"), d)
    assert first["rcs"] == [0] * len(first["rcs"]), first["stderr"][-3000:]
    for i in range(130):
        shutil.copy(wf.samples("jax")[0], d / f"c{i}.bcf")
    (d / "files.txt").write_text("\n".join(wf.samples("jax")) + "\n")
    return (wf, *run_both(wf.cases, d))


def test_discovery_matches_jax(runs):
    """The per-sample `sr` BCFs of the cohort and the `cnv` BCFs that
    merge reads."""
    assert len(check_case(*runs[1:], "discovery")) == 6


def test_germline_chain_matches_jax(runs):
    sites, geno, germ = check_case(*runs[1:], "germline")
    assert len(sites) >= 3 and len(geno) == len(sites)
    assert len(geno[0].split("\t")) == 9 + 4  # one column per sample
    assert germ


def test_somatic_chain_matches_jax(runs):
    """A joint tumor + control call, then the somatic filter: the
    tumor-only DELs are kept and the germline ones dropped."""
    wf = runs[0]
    joint, kept = check_case(*runs[1:], "somatic")
    assert len(joint) == len(wf.germ) + len(wf.soma)
    loci = {(r.split("\t")[0], int(r.split("\t")[1])) for r in kept}
    for cname, bp1, _bp2 in wf.soma:
        assert any(c == cname and abs(p - bp1) < 60 for c, p in loci)
    for cname, bp1, _bp2 in wf.germ:
        assert not any(c == cname and abs(p - bp1) < 60 for c, p in loci)


@pytest.mark.parametrize("case", ["-u 100 chunked", "file list", "-c", "-p",
                                  "-b 100", "-r 0.5", "-e -y 0 cnv",
                                  "-e -y 0 -q 2 cnv"])
def test_merge_options_match_jax(runs, case):
    (merged,) = check_case(*runs[1:], case)
    assert merged


@pytest.mark.parametrize("case,n", [
    ("merge vcf", 1), ("germline vcf", 1), ("somatic vcf", 1),
    ("zero-coverage control", 0), ("missing GT", 1)])
def test_inline_vcfs_match_jax(runs, case, n):
    (records,) = check_case(*runs[1:], case)
    assert len(records) == n

"""The PyTorch port stands alone: no module of delly_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package delly_tpu.
Also the port's device and host-axis rules."""

import argparse
import ast
import os

import pytest

from torch_card import torch_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("sr", "lr", "cnv", "asm", "merge", "filter")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "delly_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_delly_tpu_imports():
    files = _port_files()
    assert len(files) > 40
    bad = [(os.path.relpath(p, REPO), mod) for p in files
           for mod in _imports(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "delly_tpu")]
    assert bad == []


def test_cuda_device_without_card_raises(monkeypatch):
    import torch

    from delly_tpu_torch.utils import torchenv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in ("cuda", ""):
        monkeypatch.setenv(torchenv.ENV, value)
        torchenv.reset()
        with pytest.raises(RuntimeError):
            torchenv.device()
    monkeypatch.setenv(torchenv.ENV, "auto")
    torchenv.reset()
    with pytest.raises(ValueError):
        torchenv.device()
    monkeypatch.setenv(torchenv.ENV, "cpu")
    torchenv.reset()
    assert torchenv.device().type == "cpu"
    torchenv.reset()


def test_host_axis_is_single_process(monkeypatch):
    """Without a request the host axis is one process; a world that is
    asked for and cannot form raises (tests/test_torch_hostaxis.py forms
    real ones)."""
    from delly_tpu_torch.parallel import hostaxis

    for var in ("DELLY_TPU_DIST", "DELLY_TPU_COORD", "DELLY_TPU_NPROC",
                "DELLY_TPU_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert hostaxis.maybe_init() is False
    assert hostaxis.process_count() == 1 and hostaxis.is_writer()
    assert hostaxis.exchange_owned({1: "a"}) == {1: "a"}
    monkeypatch.setenv("DELLY_TPU_COORD", "localhost:1234")
    monkeypatch.setenv("DELLY_TPU_NPROC", "2")
    with pytest.raises(RuntimeError):
        hostaxis.maybe_init()


@pytest.mark.parametrize("env", [
    {"DELLY_TPU_DIST": "pod"},
    {"DELLY_TPU_DIST": "auto"},
    {"DELLY_TPU_COORD": "localhost:1234", "DELLY_TPU_PROC_ID": "0"},
    {"DELLY_TPU_COORD": "localhost:1234", "DELLY_TPU_NPROC": "two",
     "DELLY_TPU_PROC_ID": "0"},
])
def test_host_axis_world_that_cannot_form_raises(monkeypatch, env):
    """An unknown DELLY_TPU_DIST, torchrun's rendezvous without its
    variables, and an env triplet with a word missing or not a number
    raise: the port never carries on as one process."""
    import torch.distributed as dist

    from delly_tpu_torch.parallel import hostaxis

    for var in ("DELLY_TPU_DIST", "DELLY_TPU_COORD", "DELLY_TPU_NPROC",
                "DELLY_TPU_PROC_ID", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError):
        hostaxis.maybe_init()
    assert not dist.is_initialized() and hostaxis.process_count() == 1


def test_cram_run_under_mesh_imports_no_jax(tmp_path, monkeypatch):
    """A port CLI run over a CRAM under DELLY_TPU_MESH=2 ends with
    neither jax nor any delly_tpu module imported."""
    from bamsynth import make_multi_sv_dataset
    from torch_card import run_ok

    from delly_tpu_torch.io.bam import BamFile
    from delly_tpu_torch.io.cram import write_cram

    bam, fa, _truth = make_multi_sv_dataset(
        str(tmp_path), n_contigs=1, contig_len=100_000, pairs_per_contig=1500)
    cram = str(tmp_path / "r0.cram")
    write_cram(BamFile(bam), fa, cram, version=(3, 1))
    monkeypatch.setenv("DELLY_TPU_MESH", "2")
    out = run_ok("delly_tpu_torch", [
        ["sr", "-g", fa, "-o", str(tmp_path / "o.vcf"), cram]], tmp_path)
    assert out["leaked"] == []
    assert out["counts"]["host_routes"] == 0
    body = [ln for ln in open(tmp_path / "o.vcf") if not ln.startswith("#")]
    assert body


def test_other_words_not_ported(capsys):
    """No word of the JAX package's CLI is left unported: the port's CLI
    keeps no list of refused words and answers --help for every one."""
    from delly_tpu_torch import cli

    assert not hasattr(cli, "NOT_PORTED")
    for word in WORDS:
        with pytest.raises(SystemExit) as exc:
            cli.main([word, "--help"])
        assert exc.value.code == 0
        assert f"usage: delly-tpu-torch {word}" in capsys.readouterr().out


def _subparsers(cli):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command")
    for word in WORDS:
        getattr(cli, f"_add_{word}")(sub)
    return sub.choices


def _options(parser):
    return sorted((a.dest, tuple(a.option_strings), repr(a.default),
                   getattr(a.type, "__name__", None), repr(a.choices),
                   a.nargs, a.required, type(a).__name__)
                  for a in parser._actions)


@pytest.mark.parametrize("word", WORDS)
def test_parser_matches_jax(word):
    """Every option of every word, with its default, type and choices,
    as the JAX package's parser has it."""
    import delly_tpu.cli as jcli
    import delly_tpu_torch.cli as pcli

    assert (_options(_subparsers(pcli)[word])
            == _options(_subparsers(jcli)[word]))


@pytest.fixture
def inputs(tmp_path):
    """A genome, two BAMs, a call set and a sample file."""
    import random

    from bamsynth import encode_record, random_contig, write_bam, write_fasta

    fa = str(tmp_path / "r.fa")
    ref = random_contig(random.Random(1), 20_000)
    write_fasta(fa, [("c1", ref)])
    bams = []
    for i in range(2):
        bams.append(str(tmp_path / f"r{i}.bam"))
        write_bam(bams[-1], [("c1", ref)], [encode_record(
            "r0", 0, 0, 10, 60, [("M", 100)], -1, -1, 0, ref[10:110])])
    vcf = tmp_path / "calls.vcf"
    vcf.write_text("\n".join([
        "##fileformat=VCFv4.2", "##contig=<ID=c1,length=20000>",
        '##INFO=<ID=END,Number=1,Type=Integer,Description="E">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="T">',
        '##INFO=<ID=PRECISE,Number=0,Type=Flag,Description="P">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
        '##FORMAT=<ID=RR,Number=1,Type=Integer,Description="G">',
        '##FORMAT=<ID=RV,Number=1,Type=Integer,Description="G">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tt\tc",
        "c1\t5000\tDEL1\tG\t<DEL>\t900\tPASS\tPRECISE;SVTYPE=DEL;"
        "END=9000\tGT:RR:RV\t0/1:10:9\t0/0:20:0"]) + "\n")
    tsv = tmp_path / "samples.tsv"
    tsv.write_text("t\ttumor\nc\tcontrol\n")
    return fa, bams, str(vcf), str(tsv)


# (word, runner the CLI calls, options besides the inputs)
CONFIG_CASES = [
    ("cnv", "coral.run_cnv", []),
    ("cnv", "coral.run_cnv", [
        "-q", "5", "-c", "cov.gz", "-u", "seg.gz", "-z", "2000",
        "--penalty", "2.5", "-y", "3", "-p", "0.8", "--haploid-chr", "c1",
        "-w", "5000", "--scan-window", "20000", "--basecov",
        "--no-regional-gc",
        "--percentile", "0.001", "--statsfile", "st.gz"]),
    ("cnv", "coral.run_cnv", ["--fragmentcov", "--no-window-selection"]),
    ("asm", "asmode.run_asm", []),
    ("asm", "asmode.run_asm", ["-y", "diploid", "-t", "DEL,INS", "-q", "5",
                               "-a", "0.8", "-i", "5000", "-w", "500"]),
    ("merge", "merge.run_merge", []),
    ("merge", "merge.run_merge", [
        "-y", "100", "-u", "50", "-e", "-c", "-p", "-b", "500", "-r", "0.6",
        "--tr-seqid", "0.6", "--cnv-gain-uniq", "0.8", "-g", "r.fa"]),
    ("filter", "filter.filter_run", []),
    ("filter", "filter.filter_run", [
        "-f", "germline", "-y", "100", "-t", "--no-refine", "-a", "0.05",
        "--cnv-ploidy", "3", "-w", "0.01"]),
]


@pytest.mark.parametrize("word,runner,argv", CONFIG_CASES)
def test_cli_configs_match_jax(monkeypatch, torch_cpu, inputs, word, runner,
                               argv):
    """The port's word builds the same config from the same arguments as
    the JAX package's, and hands it to the same runner."""
    import importlib

    import delly_tpu.cli as jcli
    import delly_tpu_torch.cli as pcli

    fa, bams, vcf, tsv = inputs
    files = {"cnv": ["-g", fa, bams[0]], "asm": ["-g", fa, *bams],
             "merge": [vcf, vcf], "filter": ["-s", tsv, vcf]}[word]
    cfgs = []
    for cli, pkg in ((jcli, "delly_tpu"), (pcli, "delly_tpu_torch")):
        module, name = runner.split(".")
        mod = importlib.import_module(f"{pkg}.models.{module}")
        monkeypatch.setattr(mod, name, lambda cfg: cfgs.append(cfg) or 0)
        args = _subparsers(cli)[word].parse_args([*argv, *files])
        args.command = word
        run = getattr(cli, "_run_command_inner", cli._run_command)
        assert run(args) == 0
    assert len(cfgs) == 2 and vars(cfgs[0]) == vars(cfgs[1])


@pytest.mark.parametrize("word", ["sr", "lr", "asm", "cnv"])
def test_device_words_need_the_card(monkeypatch, inputs, word):
    """Without a card, a word that runs on the device fails with
    torchenv's error unless DELLY_TPU_TORCH_DEVICE=cpu; it never carries
    on on the host."""
    import torch

    from delly_tpu_torch import cli
    from delly_tpu_torch.utils import torchenv

    fa, bams, _vcf, _tsv = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(torchenv.ENV, "cuda")
    torchenv.reset()
    try:
        with pytest.raises(RuntimeError, match=torchenv.ENV):
            cli.main([word, "-g", fa, "-o", "-", bams[0]])
    finally:
        torchenv.reset()


@pytest.mark.parametrize("word", ["merge", "filter"])
def test_host_words_resolve_no_device(monkeypatch, tmp_path, inputs, word):
    """merge and filter are host commands: they run without a card and
    never resolve the device."""
    import torch

    from delly_tpu_torch import cli
    from delly_tpu_torch.utils import torchenv

    _fa, _bams, vcf, tsv = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(torchenv.ENV, "cuda")
    torchenv.reset()
    out = str(tmp_path / "out.vcf")
    argv = {"merge": ["merge", "-o", out, vcf, vcf],
            "filter": ["filter", "-s", tsv, "-o", out, vcf]}[word]
    try:
        assert cli.main(argv) == 0
        assert torchenv._device is None
    finally:
        torchenv.reset()
    assert open(out).read().startswith("##fileformat=VCF")


@pytest.mark.parametrize("name,args", [
    ("process_index", ()), ("process_count", ()), ("is_writer", ()),
    ("owner_of", (5,)), ("owns", (5,)), ("partition_plan", ([3, 1, 2],)),
    ("allgather_obj", ({"sv": 1},)), ("exchange_owned", ({2: "b"},)),
    ("barrier", ("lr-done",)),
])
def test_host_axis_identities_match_jax(monkeypatch, name, args):
    """Every host-axis helper the sr and lr drivers call gives, in one
    process, what the JAX package's gives outside a process world."""
    from delly_tpu.parallel import hostaxis as jhostaxis
    from delly_tpu_torch.parallel import hostaxis

    for var in ("DELLY_TPU_DIST", "DELLY_TPU_COORD", "DELLY_TPU_NPROC"):
        monkeypatch.delenv(var, raising=False)
    assert getattr(hostaxis, name)(*args) == getattr(jhostaxis, name)(*args)

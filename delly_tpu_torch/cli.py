"""Command-line interface of the PyTorch port.

Reference: src/delly.cpp (dispatch). The port serves every word of the
JAX package's CLI, with the same options and defaults:

- ``sr``: short-read SV discovery and genotyping (re-genotyping with
  ``-v``);
- ``lr``: long-read SV discovery and genotyping, with methylation,
  HP/PS phasing, ``-l`` alternate alignments and re-genotyping with
  ``-v``;
- ``asm``: SV discovery in haplotype assemblies (squashed or diploid);
- ``cnv``: read-depth CNV discovery and genotyping (``-v``);
- ``merge``: one site list from many samples' BCFs (``-e`` for CNVs);
- ``filter``: germline or somatic (tumor/control) filtering.

``sr``, ``lr``, ``asm`` and ``cnv`` run on the run's device
(``DELLY_TPU_TORCH_DEVICE``, ``cuda`` by default), resolved before any
work; ``merge`` and ``filter`` are host commands and resolve none.
Alignments are read from BAM or CRAM. ``DELLY_TPU_MESH`` splits the
kernels' job batches over several devices (``_mesh_scope``), and
``DELLY_TPU_COORD``/``DELLY_TPU_NPROC``/``DELLY_TPU_PROC_ID`` or
``DELLY_TPU_DIST=auto`` run one command over several processes
(parallel/hostaxis.py), process 0 writing the outputs.

    python -m delly_tpu_torch.cli sr -g ref.fa -o out.vcf sample.bam
    python -m delly_tpu_torch.cli lr -g ref.fa -o out.vcf sample.bam
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

def _startup_checks(genome: str | None = None, files=(), exclude: str = "",
                    vcffile: str = "", alignment: bool = True) -> int:
    """Checked startup diagnostics (reference delly.h:282-372): verify
    every input exists and is readable BEFORE the pipelines start, and
    emit one-line errors with exit code 1 instead of tracebacks."""
    def _missing(p):
        return not (os.path.isfile(p) and os.path.getsize(p) > 0)

    if genome:
        if _missing(genome):
            print(f"Reference file is missing: {genome}", file=sys.stderr)
            return 1
        # Parseability probe (delly.h faidx_fetch checks): a garbage or
        # binary genome should produce a one-line diagnostic up front,
        # not a KeyError deep in a pipeline.
        try:
            from delly_tpu_torch.io.fasta import FastaFile
            fa = FastaFile(genome)
            if not fa.names:
                raise ValueError("no sequences found")
        except Exception as exc:
            print(f"Fail to open genome fasta index for {genome} "
                  f"({type(exc).__name__}: {exc})", file=sys.stderr)
            return 1
    for f in files:
        if _missing(f):
            kind = "Alignment" if alignment else "Input"
            print(f"{kind} file is missing: {f}", file=sys.stderr)
            return 1
        if alignment:
            with open(f, "rb") as fh:
                magic = fh.read(4)
            if magic != b"CRAM" and magic[:2] != b"\x1f\x8b":
                print(f"Fail to open file {f}", file=sys.stderr)
                return 1
    if exclude and _missing(exclude):
        print(f"Exclude file is missing: {exclude}", file=sys.stderr)
        return 1
    if vcffile and _missing(vcffile):
        print(f"Input VCF/BCF file is missing: {vcffile}", file=sys.stderr)
        return 1
    return 0


def _check_bam_headers(files, genome: str) -> int:
    """Cross-file header sanity (delly.h:320-331): all alignment files
    must agree on the chromosome count; chromosomes absent from the
    reference produce a warning."""
    from delly_tpu_torch.io.bam import read_bam_header
    from delly_tpu_torch.io.fasta import FastaFile
    nchr = None
    try:
        fa_names = set(FastaFile(genome).names)
    except Exception:
        fa_names = None
    for f in files:
        try:
            hdr = read_bam_header(f, genome=genome)
        except Exception as exc:
            print(f"Fail to open header for {f} ({exc})", file=sys.stderr)
            return 1
        if nchr is None:
            nchr = hdr.n_targets
        elif nchr != hdr.n_targets:
            print("BAM files have different number of chromosomes!",
                  file=sys.stderr)
            return 1
        if fa_names is not None:
            for name in hdr.names:
                if name not in fa_names:
                    print(f"Warning: BAM file chromosome {name} is NOT "
                          f"present in your reference file {genome} and "
                          f"will be skipped.", file=sys.stderr)
    return 0


def _add_sr(sub):
    # add_help=False frees -h for threads (delly.h:212 "threads,h";
    # the reference's help short is -?)
    p = sub.add_parser("sr", help="SV discovery in short-read data",
                       add_help=False)
    p.add_argument("--help", action="help",
                   help="show this help message and exit")
    p.add_argument("-t", "--svtype", default="ALL")
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-x", "--exclude", default="")
    p.add_argument("-o", "--outfile", default="-")
    p.add_argument("-q", "--map-qual", type=int, default=1)
    p.add_argument("-r", "--qual-tra", type=int, default=20)
    p.add_argument("-s", "--mad-cutoff", type=int, default=9)
    p.add_argument("-c", "--minclip", type=int, default=25)
    p.add_argument("-z", "--min-clique-size", type=int, default=2)
    p.add_argument("-m", "--minrefsep", type=int, default=25)
    p.add_argument("-n", "--maxreadsep", type=int, default=40)
    p.add_argument("-p", "--max-reads", type=int, default=20)
    p.add_argument("-v", "--vcffile", default="")
    p.add_argument("-u", "--geno-qual", type=int, default=5)
    p.add_argument("-d", "--dump", default="")
    p.add_argument("-a", "--max-geno-count", type=int, default=250)
    p.add_argument("-j", "--pruning", type=int, default=1000,
                   help="PE graph pruning cutoff")
    p.add_argument("-w", "--cons-window", type=int, default=100,
                   help="consensus window")
    p.add_argument("-h", "--threads", type=int, default=4)
    p.add_argument("input_files", nargs="+")
    return p


def _add_lr(sub):
    p = sub.add_parser("lr", help="SV discovery in long-read data")
    p.add_argument("-t", "--svtype", default="ALL")
    p.add_argument("-y", "--technology", default="ont",
                   choices=["ont", "pb"])
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-x", "--exclude", default="")
    p.add_argument("-o", "--outfile", default="-")
    p.add_argument("-l", "--alt-align", default="",
                   help="alternate alignments config file")
    p.add_argument("-q", "--map-qual", type=int, default=1)
    p.add_argument("-c", "--minclip", type=int, default=25)
    p.add_argument("-z", "--min-clique-size", type=int, default=3)
    p.add_argument("-m", "--minrefsep", type=int, default=30)
    p.add_argument("-n", "--maxreadsep", type=int, default=500)
    p.add_argument("-p", "--max-reads", type=int, default=15)
    p.add_argument("-w", "--cons-window", type=int, default=1000)
    p.add_argument("-f", "--flank-size", type=int, default=100)
    p.add_argument("-a", "--flank-quality", type=float, default=0.9)
    p.add_argument("-i", "--indel-size", type=int, default=10000)
    p.add_argument("-k", "--mei-minfrac", type=float, default=0.8)
    p.add_argument("-r", "--tr-minfrac", type=float, default=0.85)
    p.add_argument("-j", "--methyl-window", type=int, default=1000)
    p.add_argument("-e", "--methyl-prob", type=int, default=128)
    p.add_argument("--min-cpg-depth", type=int, default=5)
    p.add_argument("-v", "--vcffile", default="")
    p.add_argument("-u", "--geno-qual", type=int, default=5)
    p.add_argument("-d", "--dump", default="")
    p.add_argument("-b", "--max-geno-count", type=int, default=250)
    p.add_argument("--pruning", type=int, default=1000,
                   help="graph pruning cutoff")
    p.add_argument("--extension", type=float, default=None,
                   help="enforce indel extension (default: technology preset)")
    p.add_argument("--read-cap", type=int, default=25,
                   help="max. per-read genotype quality")
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("input_files", nargs="+")
    return p


def _svtypes_to_set(svtype: str) -> set:
    """util.h:371-412."""
    from delly_tpu_torch.utils.tags import SVT_TRANS
    if svtype == "ALL":
        return set()
    out = set()
    m = {
        "DEL": [2], "INS": [4], "DUP": [3], "INV": [0, 1],
        "INV_3to3": [0], "INV_5to5": [1],
        "BND": [SVT_TRANS, SVT_TRANS + 1, SVT_TRANS + 2, SVT_TRANS + 3],
        "BND_3to3": [SVT_TRANS], "BND_5to5": [SVT_TRANS + 1],
        "BND_3to5": [SVT_TRANS + 2], "BND_5to3": [SVT_TRANS + 3],
    }
    for tok in svtype.split(","):
        if tok not in m:
            raise SystemExit(
                "Please specify a valid SV type, i.e., -t INV or -t DEL,INV")
        out.update(m[tok])
    return out


def _add_cnv(sub):
    p = sub.add_parser("cnv", help="CNV discovery (read-depth)")
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-q", "--quality", type=int, default=10)
    p.add_argument("-o", "--outfile", default="-")
    p.add_argument("-c", "--covfile", default="")
    p.add_argument("-u", "--segmentation", default="")
    p.add_argument("-z", "--cnv-size", type=int, default=1000)
    p.add_argument("-v", "--vcffile", default="")
    p.add_argument("--minclip", type=int, default=25)
    p.add_argument("--minrefsep", type=int, default=30)
    p.add_argument("--min-bp-support", type=int, default=3)
    p.add_argument("--penalty", type=float, default=3.0)
    p.add_argument("--cnv-merge", type=float, default=0.25)
    p.add_argument("--cnv-min-callable", type=float, default=0.75)
    p.add_argument("-y", "--ploidy", type=float, default=2.0)
    p.add_argument("-p", "--purity", type=float, default=1.0)
    p.add_argument("--ctrl-ploidy", type=float, default=2.0)
    p.add_argument("--haploid-chr", default="")
    p.add_argument("-w", "--window", type=int, default=0)
    p.add_argument("--fraction-unique", type=float, default=0.8)
    p.add_argument("--basecov", action="store_true")
    p.add_argument("--fragmentcov", action="store_true")
    p.add_argument("--no-regional-gc", action="store_true")
    p.add_argument("--fragment", type=float, default=0.97)
    p.add_argument("--statsfile", default="")
    p.add_argument("--window-offset", type=int, default=0)
    p.add_argument("--fraction-window", type=float, default=0.25)
    p.add_argument("--mapq-uniq", type=int, default=20)
    p.add_argument("--target-reads", type=int, default=150)
    p.add_argument("--scan-window", type=int, default=None)
    p.add_argument("--scan-regions", default="")
    p.add_argument("--mad-cutoff", type=int, default=3)
    p.add_argument("--percentile", type=float, default=0.0005)
    p.add_argument("--no-window-selection", action="store_true")
    p.add_argument("input_file")
    return p


def _add_asm(sub):
    p = sub.add_parser("asm", help="SV discovery in assemblies")
    p.add_argument("-t", "--svtype", default="ALL")
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-y", "--mode", default="squashed",
                   choices=["squashed", "diploid"])
    p.add_argument("-o", "--outfile", default="-")
    p.add_argument("-q", "--map-qual", type=int, default=10)
    p.add_argument("-c", "--minclip", type=int, default=25)
    p.add_argument("-m", "--minrefsep", type=int, default=30)
    p.add_argument("-n", "--maxreadsep", type=int, default=100)
    p.add_argument("-w", "--cons-window", type=int, default=1000)
    p.add_argument("-f", "--flank-size", type=int, default=100)
    p.add_argument("-a", "--flank-quality", type=float, default=0.9)
    p.add_argument("-i", "--indel-size", type=int, default=10000)
    p.add_argument("input_files", nargs="+")
    return p


def _add_merge(sub):
    p = sub.add_parser("merge", help="merge SV site lists")
    p.add_argument("-g", "--genome", default="")
    p.add_argument("-o", "--outfile", default="-")
    p.add_argument("-y", "--quality", type=int, default=200)
    p.add_argument("-q", "--recurrent", type=int, default=10)
    p.add_argument("-u", "--chunks", type=int, default=500)
    p.add_argument("-a", "--vaf", type=float, default=0.15)
    p.add_argument("-v", "--coverage", type=int, default=5)
    p.add_argument("-m", "--minsize", type=int, default=0)
    p.add_argument("-n", "--maxsize", type=int, default=1000000)
    p.add_argument("-e", "--cnvmode", action="store_true")
    p.add_argument("-c", "--precise", action="store_true")
    p.add_argument("-p", "--pass", dest="pass_only", action="store_true")
    p.add_argument("-b", "--bp-offset", type=int, default=1000)
    p.add_argument("-r", "--rec-overlap", type=float, default=0.8)
    p.add_argument("--rep-min-af", type=float, default=0.005)
    p.add_argument("--mei-offset", type=int, default=50)
    p.add_argument("--mei-sizeratio", type=float, default=0.85)
    p.add_argument("--mei-seqid", type=float, default=0.8)
    p.add_argument("--tr-offset", type=int, default=200)
    p.add_argument("--tr-frac", type=float, default=0.25)
    p.add_argument("--tr-seqid", type=float, default=0.7)
    p.add_argument("--norm-frac", type=float, default=0.5)
    p.add_argument("--junc-seqid", type=float, default=0.7)
    p.add_argument("--seq-cutoff", type=int, default=10000)
    p.add_argument("--cnv-large-size", type=int, default=200000)
    p.add_argument("--cnv-min-uniq", type=float, default=0.75)
    p.add_argument("--cnv-gain-uniq", type=float, default=0.9)
    p.add_argument("input_files", nargs="+")
    return p


def _add_filter(sub):
    p = sub.add_parser("filter", help="somatic/germline filtering")
    p.add_argument("-f", "--filter", default="somatic",
                   choices=["somatic", "germline"])
    p.add_argument("-o", "--outfile", default="-")
    p.add_argument("-m", "--minsize", type=int, default=0)
    p.add_argument("-n", "--maxsize", type=int, default=500000000)
    p.add_argument("-y", "--quality", type=int, default=300)
    p.add_argument("-a", "--altaf", type=float, default=0.03)
    p.add_argument("-r", "--ratiogeno", type=float, default=0.75)
    p.add_argument("-p", "--pass", dest="pass_only", action="store_true")
    p.add_argument("-t", "--tag", action="store_true")
    p.add_argument("-s", "--samples", default="")
    p.add_argument("-v", "--coverage", type=int, default=10)
    p.add_argument("-c", "--controlcont", type=float, default=0.0)
    p.add_argument("--pgerm", type=float, default=0.001)
    p.add_argument("--cn-offset", type=float, default=0.2)
    p.add_argument("-e", "--rddel", type=float, default=0.8)
    p.add_argument("-u", "--rddup", type=float, default=1.2)
    p.add_argument("-j", "--genogq", type=float, default=10)
    p.add_argument("--rdist", type=int, default=250)
    p.add_argument("--rsize", type=float, default=0.8)
    p.add_argument("--maxsd", type=float, default=0.5)
    p.add_argument("--cnv-ploidy", type=int, default=2)
    p.add_argument("--cnv-reciprocal", type=float, default=0.8)
    p.add_argument("-w", "--hwe", type=float, default=0.000001)
    p.add_argument("--no-collapse", action="store_true")
    p.add_argument("--no-refine", action="store_true")
    p.add_argument("--rcorr", type=float, default=0.8)
    p.add_argument("--rminshared", type=int, default=20)
    p.add_argument("input_file")
    return p


def main(argv=None) -> int:
    # Optional run profile: DELLY_TPU_PROFILE=<path> writes a JSON
    # stage profile (per-stage wall seconds from the stage banners).
    prof = os.environ.get("DELLY_TPU_PROFILE")
    if prof:
        from delly_tpu_torch.utils.profiling import profile_run
        with profile_run(prof):
            return _dispatch(argv)
    return _dispatch(argv)


def _dispatch(argv=None) -> int:
    from delly_tpu_torch.parallel import hostaxis
    hostaxis.maybe_init()
    argv = sys.argv[1:] if argv is None else argv
    from delly_tpu_torch.version import VERSION
    if argv:
        word = argv[0]
        if word in ("version", "--version-only", "-v"):
            print(f"delly-tpu {VERSION}", file=sys.stderr)
            return 0
        if word in ("help", "-?"):
            argv = ["--help"]
    parser = argparse.ArgumentParser(
        prog="delly-tpu-torch",
        description="Structural variant discovery and genotyping on "
                    "PyTorch and CUDA")
    parser.add_argument("--version", action="version",
                        version=f"delly-tpu {VERSION}")
    sub = parser.add_subparsers(dest="command")
    _add_sr(sub)
    _add_lr(sub)
    _add_cnv(sub)
    _add_asm(sub)
    _add_merge(sub)
    _add_filter(sub)
    args, _extra = parser.parse_known_args(argv)
    if args.command is None:
        parser.print_help()
        return 0
    with _mesh_scope(args.command, getattr(args, "input_files", None)
                     or [getattr(args, "input_file", "")]):
        return _run_command(args)


# The JAX package's threshold for meshing by default, kept as it is: the
# port's cost of a mesh on a small run is not measured. An explicit
# DELLY_TPU_MESH=N always wins.
_MESH_AUTO_MIN_BYTES = 64 << 20


@contextlib.contextmanager
def _mesh_scope(command: str, input_files=None):
    """The device mesh of a run (parallel/dispatch.py):

    - ``DELLY_TPU_MESH=N`` splits the kernels' job batches of any
      command over N devices (``0``/``off``/``none``/``no`` turns it
      off; N = 1 is a real mesh of one device, which runs the same split
      and stays byte-identical). On ``cuda`` these are the first N
      visible cards; under ``DELLY_TPU_TORCH_DEVICE=cpu`` the CPU listed
      N times. N above the visible cards warns and uses them all.
    - Unset, ``sr``/``lr``/``asm``/``cnv`` mesh over every visible card
      when there are more than one and the inputs reach
      ``_MESH_AUTO_MIN_BYTES``; the host never meshes unasked.

    The mesh is made at the first kernel dispatch, after the startup
    checks. In a world of several processes each process meshes the
    cards it sees (``CUDA_VISIBLE_DEVICES`` gives each its own): its
    job batches are its own, so no dispatch is collective.
    """
    spec = os.environ.get("DELLY_TPU_MESH", "").strip().lower()
    if spec in ("0", "off", "none", "no"):
        yield None
        return
    if not spec and command not in ("sr", "lr", "asm", "cnv"):
        yield None
        return
    if not spec and input_files:
        try:
            total = sum(os.path.getsize(f) for f in input_files if f)
        except OSError:
            total = _MESH_AUTO_MIN_BYTES
        if total < _MESH_AUTO_MIN_BYTES:
            yield None
            return
    want = None
    if spec:
        try:
            want = int(spec)
        except ValueError:
            print(f"Invalid DELLY_TPU_MESH value: {spec}", file=sys.stderr)
            raise SystemExit(1)
        if want < 1:
            yield None
            return

    def build_mesh():
        import torch

        from delly_tpu_torch.parallel.mesh import make_mesh
        from delly_tpu_torch.utils import torchenv
        dev = torchenv.device()
        if dev.type == "cpu":
            if want is None:
                return None
            return make_mesh(want, devices=[dev] * want)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        n = want
        if n is None:
            if len(devices) < 2:
                return None
            n = len(devices)
        elif n > len(devices):
            print(f"Warning: DELLY_TPU_MESH={n} exceeds the "
                  f"{len(devices)} visible devices; using "
                  f"{len(devices)}.", file=sys.stderr)
            n = len(devices)
        return make_mesh(n, devices=devices)

    from delly_tpu_torch.parallel import dispatch
    with dispatch.use_mesh_factory(build_mesh):
        yield None


def _run_command(args) -> int:
    if args.command in ("merge", "filter", "asm"):
        # steps of one process: in a world of several, process 0 alone
        # runs them (every process writing the same outputs would race),
        # and everyone meets at the barrier, so that a script run by
        # every process can chain commands
        from delly_tpu_torch.parallel import hostaxis
        if hostaxis.process_count() > 1:
            if not hostaxis.is_writer():
                hostaxis.barrier(f"{args.command}-done")
                return 0
            try:
                return _run_command_inner(args)
            finally:
                hostaxis.barrier(f"{args.command}-done")
    return _run_command_inner(args)


def _run_command_inner(args) -> int:
    if args.command == "merge":
        return _run_merge(args)
    if args.command == "filter":
        return _run_filter(args)
    if args.command == "cnv":
        files = [args.input_file]
        rc = (_startup_checks(args.genome, files, vcffile=args.vcffile)
              or _check_bam_headers(files, args.genome))
    elif args.command == "asm":
        rc = (_startup_checks(args.genome, args.input_files)
              or _check_bam_headers(args.input_files, args.genome))
        if not rc and args.mode == "diploid" and len(args.input_files) % 2:
            print("Diploid mode expects an even number of BAM files "
                  "(hap1 hap2 per sample).", file=sys.stderr)
            rc = 1
    elif args.command in ("sr", "lr"):
        rc = (_startup_checks(args.genome, args.input_files, args.exclude,
                              args.vcffile)
              or _check_bam_headers(args.input_files, args.genome))
    else:
        raise SystemExit(f"Unknown subcommand: {args.command}")
    if rc:
        return rc
    # resolve the device before any work: cuda without a card raises
    from delly_tpu_torch.utils import torchenv
    torchenv.device()
    if args.command == "cnv":
        return _run_cnv(args)
    if args.command == "asm":
        from delly_tpu_torch.models.asmode import AsmConfig, run_asm
        cfg = AsmConfig(
            genome=args.genome, files=args.input_files,
            outfile=args.outfile, svtset=_svtypes_to_set(args.svtype),
            mode=args.mode, min_map_qual=args.map_qual,
            min_clip=args.minclip, min_ref_sep=args.minrefsep,
            max_read_sep=args.maxreadsep,
            min_cons_window=args.cons_window,
            min_flank_size=args.flank_size,
            flank_quality=args.flank_quality,
            indelsize=args.indel_size)
        return run_asm(cfg)
    if args.command == "sr":
        from delly_tpu_torch.models.config import SrConfig
        from delly_tpu_torch.models.sr import run_sr
        cfg = SrConfig(
            genome=args.genome, files=args.input_files,
            outfile=args.outfile, exclude=args.exclude,
            vcffile=args.vcffile, dumpfile=args.dump,
            svtset=_svtypes_to_set(args.svtype),
            min_map_qual=args.map_qual, min_tra_qual=args.qual_tra,
            mad_cutoff=args.mad_cutoff, min_clip=args.minclip,
            min_clique_size=args.min_clique_size,
            min_ref_sep=args.minrefsep, max_read_sep=args.maxreadsep,
            max_read_per_sv=args.max_reads, min_geno_qual=args.geno_qual,
            max_geno_read_count=args.max_geno_count,
            graph_pruning=args.pruning,
            min_cons_window=args.cons_window,
            max_threads=args.threads)
        return run_sr(cfg)
    from delly_tpu_torch.models.config import LrConfig
    from delly_tpu_torch.models.lr import run_lr
    cfg = LrConfig(
        genome=args.genome, files=args.input_files,
        outfile=args.outfile, exclude=args.exclude,
        vcffile=args.vcffile, dumpfile=args.dump,
        altfile=args.alt_align,
        technology=args.technology,
        svtset=_svtypes_to_set(args.svtype),
        min_map_qual=args.map_qual, min_clip=args.minclip,
        min_clique_size=args.min_clique_size,
        min_ref_sep=args.minrefsep, max_read_sep=args.maxreadsep,
        max_read_per_sv=args.max_reads, min_geno_qual=args.geno_qual,
        max_geno_read_count=args.max_geno_count,
        min_cons_window=args.cons_window,
        min_flank_size=args.flank_size,
        flank_quality=args.flank_quality,
        indelsize=args.indel_size,
        mei_min_frac=args.mei_minfrac, tr_min_frac=args.tr_minfrac,
        methyl_window=args.methyl_window, methyl_prob=args.methyl_prob,
        min_cpg_depth=args.min_cpg_depth,
        graph_pruning=args.pruning, geno_cap=args.read_cap,
        max_threads=args.threads)
    if args.extension is not None:
        # the reference parser rounds the value through float32
        import numpy as _np
        cfg.indel_extension = float(_np.float32(args.extension))
    return run_lr(cfg)


def _run_cnv(args) -> int:
    from delly_tpu_torch.models.coral import CnvConfig, run_cnv
    basecov_flag = "auto"
    if args.basecov:
        basecov_flag = "base"
    elif args.fragmentcov:
        basecov_flag = "fragment"
    cfg = CnvConfig(
        genome=args.genome, bam_file=args.input_file,
        outfile=args.outfile, covfile=args.covfile,
        segfile=args.segmentation, genofile=args.vcffile,
        stats_file=args.statsfile, scan_file=args.scan_regions,
        min_qual=args.quality, min_cnv_size=args.cnv_size,
        min_clip=args.minclip, min_ref_sep=args.minrefsep,
        min_bp_support=args.min_bp_support, penalty=args.penalty,
        cn_merge_tol=args.cnv_merge,
        cn_min_callable=args.cnv_min_callable,
        ploidy=args.ploidy, purity=args.purity,
        ctrl_ploidy=args.ctrl_ploidy, haploid_chr=args.haploid_chr,
        window_size=args.window, window_offset=args.window_offset,
        scan_window=(args.scan_window if args.scan_window is not None
                     else 10000),
        scan_window_user_set=args.scan_window is not None,
        unique_to_total_cov_ratio=args.fraction_unique,
        fragment_unique=args.fragment, frac_window=args.fraction_window,
        mapq_uniq=args.mapq_uniq, target_reads=args.target_reads,
        mad=args.mad_cutoff, exclgc=args.percentile,
        no_scan_window_selection=args.no_window_selection,
        regional_gc=not args.no_regional_gc,
        basecov_flag=basecov_flag)
    return run_cnv(cfg)


def _run_merge(args) -> int:
    files = args.input_files
    # one input that is no VCF/BCF is a file list: run_merge checks each
    # path it lists
    if len(files) > 1 or files[0].endswith((".bcf", ".vcf", ".vcf.gz")):
        rc = _startup_checks(files=files, alignment=False)
        if rc:
            return rc
    from delly_tpu_torch.models.merge import MergeConfig, run_merge
    cfg = MergeConfig(
        files=args.input_files, outfile=args.outfile,
        genome=args.genome, qualthres=args.quality,
        recurrent_samples=args.recurrent, chunksize=args.chunks,
        vaf=args.vaf, coverage=args.coverage, minsize=args.minsize,
        maxsize=args.maxsize, cnv_mode=args.cnvmode,
        filter_for_precise=args.precise,
        filter_for_pass=args.pass_only, bpoffset=args.bp_offset,
        recoverlap=args.rec_overlap, rep_min_af=args.rep_min_af,
        mei_offset=args.mei_offset, mei_size_ratio=args.mei_sizeratio,
        mei_seq_id=args.mei_seqid, tr_offset=args.tr_offset,
        tr_frac=args.tr_frac, tr_seq_id=args.tr_seqid,
        norm_frac=args.norm_frac, junc_seq_id=args.junc_seqid,
        seq_cutoff=args.seq_cutoff, cnv_large_size=args.cnv_large_size,
        cnv_min_uniq=args.cnv_min_uniq,
        cnv_gain_uniq=args.cnv_gain_uniq)
    return run_merge(cfg)


def _run_filter(args) -> int:
    rc = _startup_checks(files=[args.input_file], alignment=False)
    if rc:
        return rc
    from delly_tpu_torch.models.filter import (
        FilterConfig, filter_run, parse_sample_file,
    )
    tumor_set = set()
    control_set = set()
    if args.filter == "somatic":
        if not args.samples:
            print("Somatic filtering requires a sample file (-s)",
                  file=sys.stderr)
            return 1
        tumor_set, control_set = parse_sample_file(args.samples)
        if not tumor_set:
            print("No tumor samples specified.", file=sys.stderr)
            return 1
        if not control_set:
            print("No control samples specified.", file=sys.stderr)
            return 1
    cfg = FilterConfig(
        vcffile=args.input_file, outfile=args.outfile,
        samplefile=args.samples, filter=args.filter,
        minsize=args.minsize, maxsize=args.maxsize,
        qualthres=args.quality, altaf=args.altaf,
        ratiogeno=args.ratiogeno, coverage=args.coverage,
        controlcont=args.controlcont, pgerm=args.pgerm,
        cn_offset=args.cn_offset, rddel=args.rddel, rddup=args.rddup,
        genogq=args.genogq, rdist=args.rdist, rsize=args.rsize,
        maxsd=args.maxsd, ploidy=args.cnv_ploidy,
        rec_cnv=args.cnv_reciprocal, hwe=args.hwe,
        no_collapse=args.no_collapse, no_refine=args.no_refine,
        filter_for_pass=args.pass_only, soft_filter=args.tag,
        rcorr=args.rcorr, rminshared=args.rminshared,
        tumor_set=tumor_set, control_set=control_set)
    return filter_run(cfg)


def entry() -> None:
    """Process entry point: exit codes, and a one-line diagnostic with
    exit code 1 instead of a traceback (DELLY_TPU_DEBUG=1 prints it)."""
    rc = 0
    try:
        rc = main() or 0
    except SystemExit as exc:
        code = exc.code
        rc = 0 if code is None else (code if isinstance(code, int) else 1)
    except KeyboardInterrupt:
        rc = 130
    except Exception as exc:
        if os.environ.get("DELLY_TPU_DEBUG"):
            import traceback
            traceback.print_exc()
        print(f"Error: {type(exc).__name__}: {exc}", file=sys.stderr)
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    sys.exit(rc)


if __name__ == "__main__":
    entry()

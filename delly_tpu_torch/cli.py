"""Command-line interface of the PyTorch port.

Reference: src/delly.cpp (dispatch). The port serves the ``sr`` word
(short-read SV discovery and genotyping, and re-genotyping with ``-v``)
and the ``lr`` word (long-read SV discovery and genotyping, with
methylation, HP/PS phasing, ``-l`` alternate alignments and
re-genotyping with ``-v``) on the run's device
(``DELLY_TPU_TORCH_DEVICE``, ``cuda`` by default). The other words of
the JAX package's CLI are not ported yet and exit with status 1.

    python -m delly_tpu_torch.cli sr -g ref.fa -o out.vcf sample.bam
    python -m delly_tpu_torch.cli lr -g ref.fa -o out.vcf sample.bam
"""

from __future__ import annotations

import argparse
import os
import sys

NOT_PORTED = ("asm", "cnv", "merge", "filter")


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
        if word in NOT_PORTED:
            print(f"{word}: not yet in the PyTorch port (use "
                  f"python -m delly_tpu.cli {word})", file=sys.stderr)
            return 1
    parser = argparse.ArgumentParser(
        prog="delly-tpu-torch",
        description="Structural variant discovery and genotyping on "
                    "PyTorch and CUDA")
    parser.add_argument("--version", action="version",
                        version=f"delly-tpu {VERSION}")
    sub = parser.add_subparsers(dest="command")
    _add_sr(sub)
    _add_lr(sub)
    args, _extra = parser.parse_known_args(argv)
    if args.command is None:
        parser.print_help()
        return 0
    return _run_command(args)


def _run_command(args) -> int:
    if args.command not in ("sr", "lr"):
        raise SystemExit(f"Unknown subcommand: {args.command}")
    rc = (_startup_checks(args.genome, args.input_files, args.exclude,
                          args.vcffile)
          or _check_bam_headers(args.input_files, args.genome))
    if rc:
        return rc
    # resolve the device before any work: cuda without a card raises
    from delly_tpu_torch.utils import torchenv
    torchenv.device()
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

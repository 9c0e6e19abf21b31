"""Freeze the msaEdlib call shapes that the port's `lr` sends to the
card, from one run on the CPU, into the histogram that svbench's
long-read consensus cell reads.

    DELLY_TPU_TORCH_DEVICE=cpu python -m svbench.gen.freeze_lr OUT.json \
        [--workdir DIR] [--contigs 8] [--contig-len 200000] \
        [--var-reads 15]

It makes a `make_lr_genome_dataset` sample (delly_tpu_torch.testing.synth:
one ~1 kb DEL and one 500-bp INS a contig, heterozygous, with the noisy
set's 5% substitutions and 5% 1-bp indels), runs
`delly_tpu_torch.cli lr` on it in this process with a recorder around
models/assemble.py `_run_msa_and_align`, and writes `msa_calls`: for
each SV consensus, its type, the width of its breakpoint confidence
interval (max(ciposhigh - ciposlow, ciendhigh - ciendlow), which widens
every segment's window), the reads `select_best_reads` keeps and their
lengths, and whether it takes msaEdlib (every type but INS) or msaWFA
(INS). Identical records are counted once with their multiplicity.

Only shapes are kept: the cells make their contents from the seed. This
is a maintenance tool, run on a host with the port's CPU path; the
benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile


def _record(out_path: str, workdir: str, contigs: int, contig_len: int,
            var_reads: int) -> dict:
    from delly_tpu_torch import cli
    from delly_tpu_torch.models import assemble
    from delly_tpu_torch.testing import synth

    bam, fa, truth = synth.make_lr_genome_dataset(
        workdir, n_contigs=contigs, contig_len=contig_len,
        var_reads=var_reads, error_rate=0.05, indel_error_rate=0.05)
    calls = collections.Counter()
    real = assemble._run_msa_and_align

    def rec(cfg, target_lens, seq, snd_seq, sv, seq_store, score_store,
            early=False):
        reads = assemble.select_best_reads(seq_store, score_store,
                                           cfg.max_read_per_sv)
        ci = max(sv.ciposhigh - sv.ciposlow, sv.ciendhigh - sv.ciendlow)
        key = json.dumps({"svt": int(sv.svt), "ci": int(ci),
                          "msa": "wfa" if sv.svt == 4 else "edlib",
                          "lengths": sorted(len(s) for s in reads)},
                         sort_keys=True)
        calls[key] += 1
        return real(cfg, target_lens, seq, snd_seq, sv, seq_store,
                    score_store, early)

    assemble._run_msa_and_align = rec
    try:
        rc = cli.main(["lr", "-y", "ont", "-g", fa, "-o",
                       os.path.join(workdir, "out.vcf"), bam])
    finally:
        assemble._run_msa_and_align = real
    if rc != 0:
        raise SystemExit(f"freeze_lr: lr exited {rc}")
    out = {
        "dataset": {"generator": "make_lr_genome_dataset",
                    "n_contigs": contigs, "contig_len": contig_len,
                    "var_reads": var_reads, "error_rate": 0.05,
                    "indel_error_rate": 0.05, "svs_true": len(truth)},
        "msa_calls": [dict(json.loads(k), count=n)
                      for k, n in sorted(calls.items())],
    }
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--contigs", type=int, default=8)
    ap.add_argument("--contig-len", type=int, default=200_000)
    ap.add_argument("--var-reads", type=int, default=15)
    args = ap.parse_args(argv)
    os.environ.setdefault("DELLY_TPU_TORCH_DEVICE", "cpu")
    with tempfile.TemporaryDirectory(dir=args.workdir) as wd:
        out = _record(args.out, wd, args.contigs, args.contig_len,
                      args.var_reads)
    print(json.dumps({"msa_calls": sum(r["count"]
                                       for r in out["msa_calls"])}))


if __name__ == "__main__":
    main()

"""Freeze the batch shapes that the port's `sr` sends to the card, from
one run on the CPU, into the histograms that svbench's cells read.

    DELLY_TPU_TORCH_DEVICE=cpu python -m svbench.gen.freeze_sr OUT.json \
        [--workdir DIR] [--contig-len 600000] [--dels 150] [--coverage 8]

It makes a `make_deep_geno_dataset` sample (delly_tpu_torch.testing.synth:
100-bp pairs, heterozygous DELs with split reads), runs
`delly_tpu_torch.cli sr` on it in this process with recorders around
three calls of the port, and writes:

- `junction_jobs`: the histogram of the junction-alignment jobs that
  models/genotype_sr.py sends to K1 (HW mode), as counts of
  (ALT probe length, REF probe length, read length);
- `msa_svs`: for each SV whose split reads reach the MSA
  (models/sr.py phase 2), its sequences' lengths and, per guide-tree
  depth, each merge's (rows, columns) of both sides, as `msa_batch`
  (ops/msa.py) gives them when the SV is assembled alone; identical
  records are counted once with their multiplicity.

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


def _record(out_path: str, workdir: str, contig_len: int, dels: int,
            coverage: int) -> dict:
    from delly_tpu_torch import cli
    from delly_tpu_torch.models import genotype_sr
    from delly_tpu_torch.ops import msa
    from delly_tpu_torch.testing import synth

    bam, fa, truth = synth.make_deep_geno_dataset(
        workdir, n_contigs=1, contig_len=contig_len, dels_per_contig=dels,
        coverage=coverage)
    jobs = collections.Counter()
    items: list = []
    real_pairs = genotype_sr.batched_pairs_distance
    real_msa = msa.msa_batch

    def pairs_rec(pairs, mode=0):
        for k in range(0, len(pairs) - 1, 2):
            (alt, read), (ref, _read) = pairs[k], pairs[k + 1]
            jobs[(len(alt), len(ref), len(read))] += 1
        return real_pairs(pairs, mode)

    def msa_rec(batch_items, *args, **kwargs):
        items.extend(batch_items)
        return real_msa(batch_items, *args, **kwargs)

    genotype_sr.batched_pairs_distance = pairs_rec
    msa.msa_batch = msa_rec
    try:
        rc = cli.main(["sr", "-g", fa, "-o",
                       os.path.join(workdir, "out.vcf"), bam])
    finally:
        genotype_sr.batched_pairs_distance = real_pairs
        msa.msa_batch = real_msa
    if rc != 0:
        raise SystemExit(f"freeze_sr: sr exited {rc}")

    svs = collections.Counter()
    real_dispatch = msa._gotoh_dispatch_batch
    for seqs, d in items:
        rounds: list = []

        def dispatch_rec(pairs, ac, sc, _rounds=rounds):
            _rounds.append([[list(a1.shape), list(a2.shape)]
                            for a1, a2 in pairs])
            return real_dispatch(pairs, ac, sc)

        msa._gotoh_dispatch_batch = dispatch_rec
        try:
            real_msa([(seqs, d)], 1)
        finally:
            msa._gotoh_dispatch_batch = real_dispatch
        key = json.dumps({"lengths": sorted(len(s) for s in seqs),
                          "rounds": rounds}, sort_keys=True)
        svs[key] += 1
    out = {
        "dataset": {"generator": "make_deep_geno_dataset", "n_contigs": 1,
                    "contig_len": contig_len, "dels_per_contig": dels,
                    "coverage": coverage, "svs_true": len(truth)},
        "junction_jobs": [[*k, n] for k, n in sorted(jobs.items())],
        "msa_svs": [dict(json.loads(k), count=n)
                    for k, n in sorted(svs.items())],
    }
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--contig-len", type=int, default=600_000)
    ap.add_argument("--dels", type=int, default=150)
    ap.add_argument("--coverage", type=int, default=8)
    args = ap.parse_args(argv)
    os.environ.setdefault("DELLY_TPU_TORCH_DEVICE", "cpu")
    with tempfile.TemporaryDirectory(dir=args.workdir) as wd:
        out = _record(args.out, wd, args.contig_len, args.dels,
                      args.coverage)
    print(json.dumps({"junction_jobs": sum(r[-1] for r in
                                           out["junction_jobs"]),
                      "msa_svs": sum(r["count"] for r in out["msa_svs"])}))


if __name__ == "__main__":
    main()

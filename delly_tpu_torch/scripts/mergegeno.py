#!/usr/bin/env python
"""Sample-column merge of per-sample genotyped VCF/BCF files.

Role of `bcftools merge -m id` in the reference workflows
(README.md:95,137): after `delly-tpu sr|lr|cnv -v sites.bcf` has been
run per sample, this pastes the per-sample FORMAT columns of the
identically-sited files into one multi-sample file for `filter`.
(`delly-tpu` can also genotype all samples in one invocation, which
makes this step unnecessary for small cohorts.)

Records are matched by ID and position; every input must carry the
same sites in the same order (which `-v sites` re-genotyping
guarantees). Output format follows the extension (.bcf / .vcf.gz /
.vcf).
"""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser(
        description="merge per-sample genotyped files by site ID")
    ap.add_argument("-o", "--outfile", required=True)
    ap.add_argument("files", nargs="+")
    args = ap.parse_args()

    from delly_tpu_torch.io.vcf import VcfReader
    from delly_tpu_torch.models.merge import _write_vcf_text

    readers = [VcfReader(f) for f in args.files]
    base = readers[0]
    n = len(base.records)
    for rdr in readers[1:]:
        if len(rdr.records) != n:
            print(f"Error: {rdr.path} has {len(rdr.records)} records, "
                  f"expected {n}", file=sys.stderr)
            return 1
    body = []
    for i in range(n):
        recs = [r.records[i] for r in readers]
        key = (recs[0]["chrom"], recs[0]["pos"], recs[0]["id"])
        for r, rec in zip(readers, recs):
            if (rec["chrom"], rec["pos"], rec["id"]) != key:
                print(f"Error: site mismatch at record {i}: "
                      f"{r.path} has {(rec['chrom'], rec['pos'], rec['id'])}, "
                      f"expected {key}", file=sys.stderr)
                return 1
        r0 = recs[0]
        info = ";".join(k if v is True else f"{k}={v}"
                        for k, v in r0["info"].items())
        fmt_keys = list(r0["samples"][0].keys()) if r0.get("samples") \
            else []
        cols = [r0["chrom"], str(r0["pos"]), r0["id"], r0["ref"],
                r0["alt"], str(r0["qual"]), r0["filter"], info,
                ":".join(fmt_keys)]
        for rec in recs:
            for sm in rec.get("samples", []):
                cols.append(":".join(str(sm.get(k, "."))
                                     for k in fmt_keys))
        body.append("\t".join(cols))
    samples = [s for r in readers for s in r.samples]
    col = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
           + "\t".join(samples))
    _write_vcf_text(args.outfile, base.header_lines, col, body)
    return 0


if __name__ == "__main__":
    sys.exit(main())

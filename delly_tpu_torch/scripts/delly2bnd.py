#!/usr/bin/env python
"""Split delly BND/TRA single records into paired VCF breakend records.

Mirrors the reference helper scripts/delly2bnd.py (cyvcf2-based) using
delly_tpu_torch's own VCF layer: each BND gets two records with MATEID links
and proper bracketed breakend ALT notation per connection type.
"""

import argparse
import sys

from delly_tpu_torch.io.fasta import FastaFile
from delly_tpu_torch.io.vcf import VcfReader


def main() -> int:
    ap = argparse.ArgumentParser(description="Split BND calls")
    ap.add_argument("-v", "--vcf", required=True, help="input VCF file")
    ap.add_argument("-r", "--ref", required=True, help="input reference")
    ap.add_argument("-o", "--out", required=True, help="output VCF file")
    args = ap.parse_args()

    rdr = VcfReader(args.vcf)
    fasta = FastaFile(args.ref)

    def base_at(chrom, pos1):
        if not fasta.has_seq(chrom):
            return "N"
        b = fasta.fetch(chrom, pos1 - 1, pos1)
        return b.upper() if b else "N"

    out = []
    for line in ["##fileformat=VCFv4.2"] + rdr.header_lines:
        if line.startswith("##fileformat") and out:
            continue
        out.append(line)
    out.append('##INFO=<ID=MATEID,Number=.,Type=String,'
               'Description="ID of mate breakends">')
    out.append(rdr.column_header)

    for rec in rdr.records:
        info = rec["info"]
        if "," in rec["alt"]:
            continue  # multi-allelic
        svtype = info.get("SVTYPE")
        if svtype == "BND":
            ct = info.get("CT")
            chrom2 = info.get("CHR2")
            pos2 = int(str(info.get("POS2", 0)))
        elif svtype == "TRA":
            ct = info.get("CT")
            chrom2 = info.get("CHR2")
            pos2 = int(str(info.get("END", 0)))
        else:
            continue
        chrom = rec["chrom"]
        pos = rec["pos"]
        n1 = base_at(chrom, pos)
        n2 = base_at(chrom2, pos2)
        if ct == "3to5":
            alt1 = f"{n1}[{chrom2}:{pos2}["
            alt2 = f"]{chrom}:{pos}]{n2}"
        elif ct == "5to3":
            alt1 = f"]{chrom2}:{pos2}]{n1}"
            alt2 = f"{n2}[{chrom}:{pos}["
        elif ct == "3to3":
            alt1 = f"{n1}]{chrom2}:{pos2}]"
            alt2 = f"{n2}]{chrom}:{pos}]"
        elif ct == "5to5":
            alt1 = f"[{chrom2}:{pos2}[{n1}"
            alt2 = f"[{chrom}:{pos}[{n2}"
        else:
            continue
        id1 = rec["id"] + "_1st"
        id2 = rec["id"] + "_2nd"
        raw = rec["_raw"].split("\t")
        info1 = raw[7] + f";MATEID={id2}"
        info2 = raw[7] + f";MATEID={id1}"
        rest = raw[8:]
        out.append("\t".join([chrom, str(pos), id1, n1, alt1, raw[5],
                              raw[6], info1] + rest))
        out.append("\t".join([chrom2, str(pos2), id2, n2, alt2, raw[5],
                              raw[6], info2] + rest))

    text = "\n".join(out) + "\n"
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

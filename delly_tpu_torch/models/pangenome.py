"""Pangenome graph alignments (GFA + GAF) for alternate-alignment
split-read filtering.

Reference: src/gfa.h (rGFA parse to a concatenated-sequence Graph),
src/gaf.h (GAF record / path / CIGAR parsing), src/pangenome.h
(junction extraction in graph-segment coordinates, including leading and
trailing clips). Used by the `lr` driver to keep only split reads whose
breakpoints recur in alternate linear or graph alignments
(junction.h:504-588).
"""

from __future__ import annotations

import gzip
import sys
from dataclasses import dataclass, field

from delly_tpu_torch.io.bam import (
    CDEL, CDIFF, CEQUAL, CINS, CMATCH, CIGAR_CHARS,
)
from delly_tpu_torch.utils.hashing import hash_lr
from delly_tpu_torch.utils.tags import Junction


@dataclass
class Link:
    """gfa.h:18-30."""
    fromfwd: bool
    tofwd: bool
    from_id: int
    to_id: int


@dataclass
class Graph:
    """gfa.h:49-67 — all segment sequences concatenated."""
    offset: list = field(default_factory=list)
    links: list = field(default_factory=list)
    smap: dict = field(default_factory=dict)
    sequence: str = ""

    @property
    def empty(self) -> bool:
        return not self.sequence

    def nodelen(self, nid: int) -> int:
        if nid + 1 == len(self.offset):
            return len(self.sequence) - self.offset[nid]
        if nid + 1 < len(self.offset):
            return self.offset[nid + 1] - self.offset[nid]
        return 0

    def nodeseq(self, nid: int) -> str:
        return self.sequence[self.offset[nid]:
                             self.offset[nid] + self.nodelen(nid)]


def _open_maybe_gz(path: str):
    with open(path, "rb") as fh:
        if fh.read(2) == b"\x1f\x8b":
            return gzip.open(path, "rt")
    return open(path)


def parse_gfa(path: str) -> Graph:
    """gfa.h:70-176 (S segments + 0M links)."""
    g = Graph()
    id_counter = 0
    with _open_maybe_gz(path) as fh:
        for line in fh:
            toks = line.rstrip("\n").split("\t")
            if not toks or not toks[0]:
                continue
            if toks[0] == "#":
                continue
            if toks[0] == "S":
                if len(toks) < 3:
                    # the reference logs and returns the partial graph
                    # (gfa.h:110-117 return false; the caller ignores
                    # the status, junction.h:552)
                    print("S segment lacks sequence information!",
                          file=sys.stderr)
                    return g
                g.offset.append(len(g.sequence))
                g.sequence += toks[2]
                g.smap[toks[1]] = id_counter
                id_counter += 1
            elif toks[0] == "L":
                if len(toks) < 6:
                    continue
                # the reference logs and returns the partial graph
                # (gfa.h:125-152 return false; caller ignores it,
                # junction.h:552)
                if toks[1] not in g.smap or toks[3] not in g.smap:
                    print("Link with unknown segment!", file=sys.stderr)
                    return g
                if toks[5] != "0M":
                    print("Currently only 0M links are supported!",
                          file=sys.stderr)
                    return g
                g.links.append(Link(toks[2] != "-", toks[4] != "-",
                                    g.smap[toks[1]], g.smap[toks[3]]))
    print(f"GFA loaded: {len(g.offset)} segments, {len(g.links)} links, "
          f"seq.size: {len(g.sequence)}", file=sys.stderr)
    return g


@dataclass
class AlignRecord:
    """gaf.h:18-42."""
    qlen: int = 0
    qstart: int = 0
    qend: int = 0
    plen: int = 0
    pstart: int = 0
    pend: int = 0
    matches: int = 0
    alignlen: int = 0
    mapq: int = 0
    strand: str = "*"
    seed: int = 0
    path: list = field(default_factory=list)  # [(forward, tid), ...]
    cigarop: list = field(default_factory=list)
    cigarlen: list = field(default_factory=list)


_CIGAR_CODE = {ch: i for i, ch in enumerate(CIGAR_CHARS)}


def parse_gaf_cigar(cigar: str, ar: AlignRecord) -> None:
    """gaf.h:44-58."""
    nstart = 0
    for i, ch in enumerate(cigar):
        if not ch.isdigit():
            ar.cigarlen.append(int(cigar[nstart:i]))
            ar.cigarop.append(_CIGAR_CODE.get(ch, -1))
            nstart = i + 1


def parse_gaf_path(path: str, g: Graph, ar: AlignRecord) -> bool:
    """gaf.h:60-92 (>/< oriented segment path)."""
    if not path:
        return False
    if path[0] not in "<>":
        return False
    breaks = [i for i, ch in enumerate(path) if ch in "<>"]
    for bi, b in enumerate(breaks):
        forward = path[b] == ">"
        seg = (path[b + 1:breaks[bi + 1]] if bi + 1 < len(breaks)
               else path[b + 1:])
        if seg not in g.smap:
            print(f"Unknown segment {seg}", file=sys.stderr)
            return False
        ar.path.append((forward, g.smap[seg]))
    return True


def parse_align_record(line: str, g: Graph, valid_sr: set | None = None):
    """gaf.h:94-149. Returns (AlignRecord, qname) or None."""
    line = line.rstrip("\n")
    if not line:
        return None
    toks = line.split("\t")
    if len(toks) < 12:
        return None
    qname = toks[0]
    if valid_sr and hash_lr(qname) not in valid_sr:
        return None
    ar = AlignRecord()
    ar.seed = hash_lr(qname)
    ar.qlen = int(toks[1])
    ar.qstart = int(toks[2])
    ar.qend = int(toks[3])
    ar.strand = toks[4]
    if not g.empty:
        if not parse_gaf_path(toks[5], g, ar):
            return None
    ar.plen = int(toks[6])
    ar.pstart = int(toks[7])
    ar.pend = int(toks[8])
    ar.matches = int(toks[9])
    ar.alignlen = int(toks[10])
    ar.mapq = int(toks[11])
    for opt in toks[12:]:
        kv = opt.split(":")
        if kv and kv[0] == "cg" and len(kv) >= 3:
            parse_gaf_cigar(kv[2], ar)
    return ar, qname


def _insert_graph_junction(read_bp: dict, seed: int, ar: AlignRecord,
                           pathidx: int, rp: int, sp: int,
                           scleft: bool) -> None:
    """pangenome.h:31-43."""
    if sp <= ar.qlen:
        fw = ar.path[pathidx][0]
        read_bp.setdefault(seed, []).append(
            Junction(fw, scleft, ar.path[pathidx][1], ar.qstart, rp, sp,
                     ar.mapq))


def find_graph_junctions(cfg, g: Graph, gaf_files: list, read_bp: dict,
                         valid_sr: set) -> None:
    """Junction extraction in graph-segment coordinates
    (pangenome.h:46-220)."""
    print("Split-read scanning", file=sys.stderr)
    for path in gaf_files:
        with _open_maybe_gz(path) as fh:
            for line in fh:
                parsed = parse_align_record(line, g, valid_sr)
                if parsed is None:
                    continue
                ar, _qname = parsed
                if ar.mapq < cfg.min_map_qual:
                    continue
                refstart = 0
                for pi, (forward, tid) in enumerate(ar.path):
                    seqlen = g.nodelen(tid)
                    pstart = 0
                    plen = seqlen
                    if pi == 0:
                        plen -= ar.pstart
                        if forward:
                            pstart = ar.pstart
                    if pi + 1 == len(ar.path):
                        plen = ar.pend - ar.pstart - refstart
                        if not forward:
                            if pi == 0:
                                pstart = seqlen - ar.pend
                            else:
                                pstart = (ar.pstart + refstart + seqlen
                                          - ar.pend)

                    refend = refstart + plen
                    # local alignment end in segment coordinates
                    rp = 0
                    srpend = 0
                    for op, ol in zip(ar.cigarop, ar.cigarlen):
                        if op in (CMATCH, CEQUAL, CDIFF, CDEL):
                            for _ in range(ol):
                                if refstart <= rp < refend:
                                    srpend += 1
                                rp += 1

                    rp = 0
                    srp = 0
                    sp = ar.qstart
                    # Leading junction
                    if pi == 0 and sp > cfg.min_ref_sep:
                        locbeg = pstart + 1 + srp
                        if not forward:
                            locbeg = pstart + 1 + (srpend - srp)
                        if 0 < locbeg < seqlen:
                            _insert_graph_junction(read_bp, ar.seed, ar,
                                                   pi, locbeg, sp, forward)
                    for op, ol in zip(ar.cigarop, ar.cigarlen):
                        if op in (CMATCH, CEQUAL, CDIFF):
                            for _ in range(ol):
                                if refstart <= rp < refend:
                                    srp += 1
                                sp += 1
                                rp += 1
                        elif op == CDEL:
                            if ol > cfg.min_ref_sep \
                                    and refstart <= rp < refend:
                                locbeg = pstart + 1 + srp
                                if not forward:
                                    locbeg = pstart + 1 + (srpend - srp
                                                           - ol)
                                if 0 < locbeg < seqlen:
                                    _insert_graph_junction(
                                        read_bp, ar.seed, ar, pi, locbeg,
                                        sp, False)
                            for _ in range(ol):
                                if refstart <= rp < refend:
                                    srp += 1
                                rp += 1
                            if ol > cfg.min_ref_sep \
                                    and refstart <= rp < refend:
                                locbeg = pstart + 1 + srp
                                if not forward:
                                    locbeg = (pstart + 1
                                              + (srpend - srp) + ol)
                                if 0 < locbeg < seqlen:
                                    _insert_graph_junction(
                                        read_bp, ar.seed, ar, pi, locbeg,
                                        sp, True)
                        elif op == CINS:
                            if ol > cfg.min_ref_sep \
                                    and refstart <= rp < refend:
                                locbeg = pstart + 1 + srp
                                if not forward:
                                    locbeg = pstart + 1 + (srpend - srp)
                                if 0 < locbeg < seqlen:
                                    _insert_graph_junction(
                                        read_bp, ar.seed, ar, pi, locbeg,
                                        sp, not forward)
                            sp += ol
                            if ol > cfg.min_ref_sep \
                                    and refstart <= rp < refend:
                                locbeg = pstart + 1 + srp
                                if not forward:
                                    locbeg = pstart + 1 + (srpend - srp)
                                if 0 < locbeg < seqlen:
                                    _insert_graph_junction(
                                        read_bp, ar.seed, ar, pi, locbeg,
                                        sp, forward)
                        else:
                            # unknown op: warn and stop the scan like
                            # the reference (pangenome.h:187-190
                            # return false)
                            print(f"Warning: Unknown Cigar option {op}",
                                  file=sys.stderr)
                            for jv in read_bp.values():
                                jv.sort(key=lambda j: j.sort_key())
                            return
                    # Trailing junction
                    if (pi + 1 == len(ar.path)
                            and sp + cfg.min_ref_sep < ar.qlen):
                        locbeg = pstart + 1 + srp
                        if not forward:
                            locbeg = pstart + 1 + (srpend - srp)
                        if 0 < locbeg < seqlen:
                            _insert_graph_junction(read_bp, ar.seed, ar,
                                                   pi, locbeg, sp,
                                                   not forward)
                    refstart = refend
    for jv in read_bp.values():
        jv.sort(key=lambda j: j.sort_key())


def find_graph_sr_breakpoints(cfg, g: Graph, gaf_files: list, sr_br: list,
                              valid_sr: set) -> None:
    """pangenome.h:222-231."""
    from delly_tpu_torch.models.junctions import fetch_svs
    read_bp = {}
    find_graph_junctions(cfg, g, gaf_files, read_bp, valid_sr)
    fetch_svs(read_bp, sr_br, cfg.svtset, cfg.max_read_sep,
              cfg.min_ref_sep)


def parse_alternate_alignments(altfile: str):
    """util.h:328-361: two-column '<align> <genome>' config.
    Returns (align_paths, genome_paths)."""
    align = []
    genome = []
    with open(altfile) as fh:
        for line in fh:
            toks = line.rstrip("\n").split("\t")
            toks = [t for t in toks if t]
            if not toks:
                continue
            if len(toks) < 2:
                raise ValueError(
                    "Alternate alignment config file needs 2 columns "
                    "'<align.bam> <genome.fa>' for each alternate "
                    "alignment.")
            align.append(toks[0])
            genome.append(toks[1])
    return align, genome


def is_bam_cram(path: str) -> bool:
    """Content sniff like htslib hts_detect_format (util.h:602-609
    role), not a filename-extension guess."""
    try:
        with open(path, "rb") as fh:
            magic = fh.read(4)
    except OSError:
        return False
    if magic == b"CRAM":
        return True
    if magic[:2] == b"\x1f\x8b":
        from delly_tpu_torch.io.bgzf import BgzfReader
        rd = BgzfReader(path)
        try:
            return rd.read_prefix_blocks(4)[:4] == b"BAM\x01"
        except Exception:
            return False
        finally:
            rd.close()
    return False

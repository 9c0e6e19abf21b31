"""Long-read consensus assembly.

Reference: src/assemble.h. Two consensus paths:

- ``msa_edlib`` (non-INS SVs, assemble.h:383-473): all-pairs NW edit
  distances -> centroid seed -> drop poorest 20% -> incremental NW
  alignment of each read onto the running IUPAC column consensus.
- ``msa_wfa`` (INS SVs, assemble.h:547-725): 7-mer k-mer tables and a
  best-diagonal sliding window find the read overlap layout, a
  superstring is grown across reads (assemble.h:90-133), then every read
  is HW-aligned back onto the superstring consensus and the result is
  trimmed/oriented against reference prefix/suffix probes
  (assemble.h:338-365).

The all-pairs edit-distance matrices are the batched device kernel's
domain (ops.edist.batched_edit_distance); the irregular superstring /
column bookkeeping stays on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from delly_tpu_torch.io.bam import (
    FDUP, FQCFAIL, FREVERSE, FSECONDARY, FSUPPLEMENTARY, FUNMAP,
)
from delly_tpu_torch.models.refine import align_consensus
from delly_tpu_torch.ops.edist import (
    EDOP_DELETE, EDOP_INSERT, MODE_HW, MODE_NW, align, edit_distance,
    equality_matrix, infix_start,
)
from delly_tpu_torch.ops.msa import consensus as column_consensus
from delly_tpu_torch.utils.hashing import hash_lr
from delly_tpu_torch.utils.tags import is_translocation, revcomp, span_orientation

DELLY_KMER = 7  # tags.h:19
DUPLICATE = np.iinfo(np.uint32).max  # tags.h:15

GAP = ord("-")

# Extended IUPAC equalities used when re-aligning reads onto a consensus
# that contains two-letter ambiguity codes (assemble.h:425). B/D/E/F are
# delly-private codes for base+gap columns.
IUPAC_PAIRS = [
    ("M", "A"), ("M", "C"), ("R", "A"), ("R", "G"), ("W", "A"), ("W", "T"),
    ("B", "A"), ("B", "-"), ("S", "C"), ("S", "G"), ("Y", "C"), ("Y", "T"),
    ("D", "C"), ("D", "-"), ("K", "G"), ("K", "T"), ("E", "G"), ("E", "-"),
    ("F", "T"), ("F", "-"),
]
IUPAC_EQ = equality_matrix(IUPAC_PAIRS)

# Two-letter ambiguity code for an (ordered) pair of ACGT- column winners
# (assemble.h:246-256).
_AMBIG = {
    (0, 1): "M", (0, 2): "R", (0, 3): "W", (0, 4): "B", (1, 2): "S",
    (1, 3): "Y", (1, 4): "D", (2, 3): "K", (2, 4): "E", (3, 4): "F",
}


@dataclass
class SeqSlice:
    """assemble.h:14-22."""
    svid: int = -1
    sstart: int = -1
    inslen: int = -1
    qual: int = -1


def _base_counts(align_mat: np.ndarray, mask: np.ndarray | None = None):
    """Per-column ACGT- counts over an alignment matrix (uint8)."""
    up = align_mat & ~np.uint8(0x20)  # fold lowercase to uppercase
    counts = np.zeros((5, align_mat.shape[1]), dtype=np.int32)
    if mask is None:
        for k, ch in enumerate(b"ACGT"):
            counts[k] = (up == ch).sum(axis=0)
        counts[4] = align_mat.shape[0] - counts[:4].sum(axis=0)
    else:
        for k, ch in enumerate(b"ACGT"):
            counts[k] = ((up == ch) & mask).sum(axis=0)
        counts[4] = mask.sum(axis=0) - counts[:4].sum(axis=0)
    return counts


_AMBIG_LUT = np.full((5, 5), ord("-"), dtype=np.uint8)
for (_k1, _k2), _ch in _AMBIG.items():
    _AMBIG_LUT[_k1, _k2] = ord(_ch)


def _ambig_consensus(counts: np.ndarray) -> str:
    """Column consensus with two-letter ambiguity codes
    (assemble.h:200-259): dominant base if it more than doubles the
    runner-up, else the IUPAC pair code. The reference's scalar scan
    resolves ties as first-maximum for both ranks, which np.argmax
    reproduces (runner-up = first argmax with the winner masked)."""
    ncols = counts.shape[1]
    cols = np.arange(ncols)
    max_idx = np.argmax(counts, axis=0)
    masked = counts.copy()
    masked[max_idx, cols] = -1
    snd_idx = np.argmax(masked, axis=0)
    max_val = counts[max_idx, cols]
    snd_val = counts[snd_idx, cols]
    base = np.frombuffer(b"ACGT-", dtype=np.uint8)[max_idx]
    amb = _AMBIG_LUT[np.minimum(max_idx, snd_idx),
                     np.maximum(max_idx, snd_idx)]
    out = np.where(2 * snd_val < max_val, base, amb)
    return out.tobytes().decode()


def consensus_edlib(align_mat: np.ndarray) -> str:
    """assemble.h:200-259 (all rows count at every column)."""
    return _ambig_consensus(_base_counts(align_mat))


def consensus_wfa(align_mat: np.ndarray) -> str:
    """assemble.h:262-336 (only columns within each read's span count)."""
    nongap = align_mat != GAP
    ncols = align_mat.shape[1]
    any_row = nongap.any(axis=1)
    first = np.where(any_row, nongap.argmax(axis=1), ncols)
    last = np.where(any_row, ncols - 1 - nongap[:, ::-1].argmax(axis=1), 0)
    col = np.arange(ncols)
    mask = (first[:, None] <= col[None, :]) & (col[None, :] <= last[:, None])
    return _ambig_consensus(_base_counts(align_mat, mask))


def _to_mat(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8).reshape(1, -1)


def convert_alignment(query: str, align_mat: np.ndarray, mode: int,
                      ops: np.ndarray, end_loc: int) -> np.ndarray:
    """Stack `query` under the alignment given the edlib-style path
    (assemble.h:24-88). HW mode re-inserts unaligned consensus flanks."""
    nrows, ncols = align_mat.shape
    missing_start = 0
    missing_end = 0
    t_idx = -1
    if mode == MODE_HW:
        t_idx = end_loc
        if t_idx < ncols:
            missing_end = ncols - t_idx - 1
        t_idx -= int(np.count_nonzero(ops != EDOP_INSERT))
        if t_idx >= 0:
            missing_start = t_idx + 1
    alen = len(ops)
    out = np.full((nrows + 1, missing_start + alen + missing_end), GAP,
                  dtype=np.uint8)
    # leading flank
    if missing_start:
        out[:nrows, :missing_start] = align_mat[:, :missing_start]
    # aligned block: target columns advance on non-INSERT ops, the
    # query row on non-DELETE ops (vectorized scatter)
    q = np.frombuffer(query.encode(), dtype=np.uint8)
    jj = np.nonzero(ops != EDOP_INSERT)[0]
    if len(jj):
        out[:nrows, missing_start + jj] = \
            align_mat[:, t_idx + 1:t_idx + 1 + len(jj)]
        t_idx += len(jj)
    kk = np.nonzero(ops != EDOP_DELETE)[0]
    if len(kk):
        out[nrows, missing_start + kk] = q[:len(kk)]
    if missing_end:
        out[:nrows, missing_start + alen:] = \
            align_mat[:, t_idx + 1:t_idx + 1 + missing_end]
    return out


def trim_consensus(prefix: str, suffix: str, cs: str) -> str:
    """Orient the consensus by the reference prefix and trim it to the
    prefix..suffix anchor span (assemble.h:338-365)."""
    prefix_rev = revcomp(prefix)
    score_fwd, _ = edit_distance(prefix, cs, MODE_HW)
    score_rev, _ = edit_distance(prefix_rev, cs, MODE_HW)
    if score_fwd > score_rev:
        cs = revcomp(cs)
    _, end_loc, ops = align(prefix, cs, MODE_HW)
    cs_start = infix_start(ops, end_loc)
    _, cs_end, _ = align(suffix, cs, MODE_HW)
    if cs_start < cs_end < len(cs):
        cs = cs[cs_start:cs_end]
    return cs


def select_best_reads(seqs: list, scores: list, max_reads: int):
    """Keep the best-spanning reads (assemble.h:369-381)."""
    if len(seqs) <= max_reads:
        return seqs
    idx = sorted(range(len(seqs)), key=lambda a: -scores[a])
    return [seqs[i] for i in idx[:max_reads]]


def _centroid_order(edit: np.ndarray, lens: list):
    """Shared seed selection + poorest-20% drop (assemble.h:397-422)."""
    n = edit.shape[0]
    best_idx = 0
    best_val = lens[0]
    for i in range(n):
        dist = np.sort(edit[i])
        if int(dist[n // 2]) < best_val:
            best_val = int(dist[n // 2])
            best_idx = i
    qscores = [(0, best_idx)]
    for j in range(n):
        if j != best_idx:
            qscores.append((int(edit[best_idx, j]), j))
    qscores.sort()
    last_idx = int(0.8 * len(qscores))
    if last_idx < 3:
        last_idx = 3
    return [q[1] for q in qscores[:last_idx]]


def _final_trim(cs: str) -> str:
    """Trim 5% (max 50bp) off both ends (assemble.h:466-469)."""
    trim = int(0.05 * len(cs))
    if trim > 50:
        trim = 50
    ln = len(cs) - 2 * trim
    if ln > 100:
        cs = cs[trim:trim + ln]
    return cs


def _all_pairs_nw(seqs: list, substrs=None) -> np.ndarray:
    """All-pairs NW distance matrix via one device batch
    (assemble.h:386-395 pairwise edlib loop). substrs optionally maps
    (i, j) -> (seq_i, seq_j) for overlap-trimmed comparisons."""
    from delly_tpu_torch.ops.edist import batched_pairs_distance

    n = len(seqs)
    idx = [(i, j) for i in range(n) for j in range(i + 1, n)]
    if not idx:
        return np.zeros((n, n), dtype=np.int32)
    if substrs is None:
        pairs = [(seqs[i], seqs[j]) for i, j in idx]
    else:
        pairs = [substrs[(i, j)] for i, j in idx]
    d = batched_pairs_distance(pairs, MODE_NW)
    edit = np.zeros((n, n), dtype=np.int32)
    for (i, j), dist in zip(idx, d):
        edit[i, j] = edit[j, i] = dist
    return edit


def msa_edlib(cfg, seqs: list) -> tuple:
    """Progressive MSA onto an IUPAC consensus (assemble.h:383-473).
    Returns (support, consensus)."""
    edit = _all_pairs_nw(seqs)
    sel = _centroid_order(edit, [len(s) for s in seqs])
    mat = _to_mat(seqs[sel[0]])
    for i in range(1, len(sel)):
        align_str = consensus_edlib(mat)
        _, end_loc, ops = align(seqs[sel[i]], align_str, MODE_NW,
                                eq=IUPAC_EQ)
        mat = convert_alignment(seqs[sel[i]], mat, MODE_NW, ops, end_loc)
    cs = column_consensus(mat, cfg.min_clique_size)
    cs = _final_trim(cs)
    return mat.shape[0], cs


def fill_kmer_table(s: str) -> np.ndarray:
    """7-mer start-position table with duplicate flagging
    (assemble.h:501-520). Value = kmer start + 1 (0 = absent)."""
    table = np.zeros(4 ** (DELLY_KMER + 1), dtype=np.uint32)
    b = np.frombuffer(s.encode(), dtype=np.uint8)
    n = len(b)
    if n < DELLY_KMER:
        return table
    # charToInt: A->0 C->1 G->2 T->3, B->0 D->1 E->2 F->3, else 0
    code = np.zeros(256, dtype=np.uint32)
    for ch, v in zip("ACGTBDEF", [0, 1, 2, 3, 0, 1, 2, 3]):
        code[ord(ch)] = v
    vals = code[b]
    # rolling hash over windows of DELLY_KMER chars
    weights = (4 ** np.arange(DELLY_KMER - 1, -1, -1)).astype(np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(vals.astype(np.uint64),
                                                   DELLY_KMER)
    hashes = (win * weights).sum(axis=1).astype(np.int64)
    starts = np.arange(len(hashes), dtype=np.uint32) + 1
    # first occurrence keeps start+1; any repeat flags DUPLICATE
    uniq, first_pos, counts = np.unique(hashes, return_index=True,
                                        return_counts=True)
    table[uniq] = np.where(counts > 1, np.uint32(DUPLICATE),
                           starts[first_pos])
    return table


def best_diagonal(k_i: np.ndarray, k_j: np.ndarray, len_i: int,
                  len_j: int) -> int:
    """Best shared-unique-kmer diagonal via a 20-wide sliding window
    (assemble.h:522-545)."""
    shared = (k_i != 0) & (k_j != 0) & (k_i != DUPLICATE) & (k_j != DUPLICATE)
    diag = np.zeros(len_i + len_j, dtype=np.int64)
    if shared.any():
        d = (len_j + k_i[shared].astype(np.int64)
             - k_j[shared].astype(np.int64))
        np.add.at(diag, d, 1)
    window = 20
    size = len(diag)
    if size <= window:
        return window // 2 - len_j
    # sliding-window sums via prefix sums; the scalar scan's
    # first-strict-maximum tie preference is np.argmax's
    cs = np.concatenate(([0], np.cumsum(diag)))
    wsum = cs[window:] - cs[:-window]
    k = int(np.argmax(wsum))
    best_diag = window // 2 if k == 0 else k + window - 1 - window // 2
    return best_diag - len_j


def build_superstring(seq_i: str, seq_j: str, ops: np.ndarray, pre_i: int,
                      post_i: int, pre_j: int, post_j: int) -> str:
    """Glue two overlapping reads into one superstring, switching source
    at the overlap midpoint (assemble.h:90-133)."""
    out = []
    i_idx = 0
    j_idx = 0
    first_seq = pre_i > pre_j
    if first_seq:
        out.append(seq_i[:pre_i])
        i_idx = pre_i
        j_idx = pre_j
    else:
        i_idx = pre_i
        out.append(seq_j[:pre_j])
        j_idx = pre_j
    bp = len(ops) // 2
    for j, op in enumerate(ops):
        if bp == j:
            first_seq = not first_seq
        if op == EDOP_DELETE:
            if not first_seq:
                out.append(seq_j[j_idx])
            j_idx += 1
        elif op == EDOP_INSERT:
            if first_seq:
                out.append(seq_i[i_idx])
            i_idx += 1
        else:
            out.append(seq_i[i_idx] if first_seq else seq_j[j_idx])
            i_idx += 1
            j_idx += 1
    if post_i > post_j:
        out.append(seq_i[i_idx:i_idx + post_i])
    else:
        out.append(seq_j[j_idx:j_idx + post_j])
    return "".join(out)


def _overlap_layout(len_i: int, len_j: int, diag: int):
    """Clip geometry of the best-diagonal overlap."""
    if diag >= 0:
        seqlen = min(len_i - diag, len_j)
        pre_i, post_i = diag, len_i - (diag + seqlen)
        pre_j, post_j = 0, len_j - seqlen
    else:
        seqlen = min(len_j + diag, len_i)
        pre_i, post_i = 0, len_i - seqlen
        pre_j, post_j = -diag, len_j - (-diag + seqlen)
    return seqlen, pre_i, post_i, pre_j, post_j


def msa_wfa(cfg, seqs: list, prefix: str = "", suffix: str = "") -> tuple:
    """Superstring-based INS consensus (assemble.h:547-725).
    Returns (support, consensus)."""
    n = len(seqs)
    tables = [fill_kmer_table(s) for s in seqs]
    substrs = {}
    for i in range(n):
        len_i = len(seqs[i])
        for j in range(i + 1, n):
            len_j = len(seqs[j])
            diag = best_diagonal(tables[i], tables[j], len_i, len_j)
            seqlen, pre_i, _, pre_j, _ = _overlap_layout(len_i, len_j, diag)
            substrs[(i, j)] = (seqs[i][pre_i:pre_i + seqlen],
                               seqs[j][pre_j:pre_j + seqlen])
    edit = _all_pairs_nw(seqs, substrs)
    for (i, j), (si, sj) in substrs.items():
        score = (int(edit[i, j]) * 1000) // max(len(si), len(sj), 1)
        edit[i, j] = edit[j, i] = score
    sel = _centroid_order(edit, [len(s) for s in seqs])

    # Build superstring
    super_str = seqs[sel[0]]
    for i in range(1, len(sel)):
        len_i = len(super_str)
        k_i = fill_kmer_table(super_str)
        len_j = len(seqs[sel[i]])
        k_j = tables[sel[i]]
        diag = best_diagonal(k_i, k_j, len_i, len_j)
        seqlen, pre_i, post_i, pre_j, post_j = _overlap_layout(
            len_i, len_j, diag)
        if pre_i > pre_j and post_i > post_j:
            pass  # nested: superstring already covers the read
        elif pre_j > pre_i and post_j > post_i:
            super_str = seqs[sel[i]]  # read covers the superstring
        else:
            seq_i = super_str[pre_i:pre_i + seqlen]
            seq_j = seqs[sel[i]][pre_j:pre_j + seqlen]
            _, _, ops = align(seq_i, seq_j, MODE_NW)
            super_str = build_superstring(super_str, seqs[sel[i]], ops,
                                          pre_i, post_i, pre_j, post_j)

    # Incrementally HW-align every selected read onto the consensus
    mat = _to_mat(super_str)
    for i in range(len(sel)):
        align_str = consensus_wfa(mat)
        _, end_loc, ops = align(seqs[sel[i]], align_str, MODE_HW,
                                eq=IUPAC_EQ)
        mat = convert_alignment(seqs[sel[i]], mat, MODE_HW, ops, end_loc)
    cs = column_consensus(mat, cfg.min_clique_size)

    if prefix and suffix:
        cs = trim_consensus(prefix, suffix, cs)
    else:
        cs = _final_trim(cs)
    return len(sel), cs


def _orient_subseq(subseq: str, sv, rec, ref_index: int) -> str:
    """Per-svt read-window orientation (assemble.h:820-828)."""
    if is_translocation(sv.svt):
        ct = span_orientation(sv.svt)
        if ct == 0 and ref_index == sv.chr2:
            subseq = revcomp(subseq)
        elif ct == 1 and ref_index == sv.chr:
            subseq = revcomp(subseq)
    elif sv.svt == 0:
        if rec.pos > (sv.svStart + sv.svEnd) // 2:
            subseq = revcomp(subseq)
    elif sv.svt == 1:
        if rec.flag & FREVERSE:
            subseq = revcomp(subseq)
    return subseq


def _run_msa_and_align(cfg, target_lens, seq, snd_seq, sv, seq_store,
                       score_store, early: bool = False) -> bool:
    """One SV's consensus + breakpoint refinement (assemble.h:834-872)."""
    reads = select_best_reads(seq_store, score_store, cfg.max_read_per_sv)
    msa_success = False
    if sv.svt != 4:
        _, sv.consensus = msa_edlib(cfg, reads)
        # Small inversions: window the consensus to the SV span
        tmp_cons = ""
        offset_tmp = 0
        sv_size = sv.svEnd - sv.svStart
        if sv.svt in (0, 1) and sv_size < len(sv.consensus):
            offset_tmp = (len(sv.consensus) - sv_size) // 2
            tmp_cons = sv.consensus
            sv.consensus = sv.consensus[offset_tmp:offset_tmp + sv_size]
        if align_consensus(cfg, target_lens, seq, snd_seq, sv, realign=True):
            msa_success = True
        if tmp_cons:
            sv.consensus = tmp_cons
            sv.consBp += offset_tmp
    else:
        seqlen = len(seq)
        prefix = seq[max(sv.svStart - cfg.min_cons_window, 0):
                     sv.svStart].upper()
        suffix = seq[sv.svStart:min(seqlen,
                                    sv.svStart + cfg.min_cons_window)].upper()
        _, sv.consensus = msa_wfa(cfg, reads, prefix, suffix)
        # Early-completion path gates on a non-empty consensus
        # (assemble.h:858); the left-over path gates on consensus size
        # (assemble.h:925).
        if early:
            proceed = bool(sv.consensus)
        else:
            proceed = (len(sv.consensus)
                       < sv.insLen + 4 * cfg.min_cons_window)
        if proceed and align_consensus(cfg, target_lens, seq, None, sv,
                                       realign=False):
            msa_success = True
    return msa_success


def assemble(cfg, bams, fasta, valid_regions, svs: list, sr_store: list):
    """Read-window collection + per-SV consensus (assemble.h:734-964).

    sr_store: per-chromosome dict {(rstart, seed): [SeqSlice, ...]}.
    Mutates svs in place (consensus, consBp, srSupport, srAlignQuality,
    svStart/svEnd refinement).
    """
    from delly_tpu_torch.parallel import hostaxis

    n_sv = len(svs)
    seq_store = [[] for _ in range(n_sv)]
    score_store = [[] for _ in range(n_sv)]
    max_candidates = cfg.max_read_per_sv * 4
    svcons = [False] * n_sv
    header = bams[0].header
    target_lens = header.lengths

    if hostaxis.process_count() > 1:
        return _assemble_hostaxis(cfg, bams, fasta, valid_regions, svs,
                                  sr_store, seq_store, score_store,
                                  max_candidates, svcons)

    for ref_index in range(header.n_targets):
        if not valid_regions[ref_index]:
            continue
        if not sr_store[ref_index]:
            continue
        seq = fasta.fetch(header.names[ref_index]).upper()
        hits = {pos for (pos, _seed) in sr_store[ref_index]}

        for bam in bams:
            # SoA prefilter (assemble.h:806-830 walks every record but
            # touches only reads whose (pos, name-seed) is in the SR
            # store): select candidate rows by position membership,
            # derive seeds from the bulk CIGAR/name-hash pass, and
            # Python-parse only confirmed store hits — row order is
            # file order, so store lookups and appends are
            # order-identical to the full walk.
            import numpy as np

            from delly_tpu_torch.models.genotype_sr import _cigar_stats
            from delly_tpu_torch.utils.hashing import hash_lr_batch

            view = bam.chrom(ref_index)
            excl = (FQCFAIL | FDUP | FUNMAP | FSECONDARY
                    | FSUPPLEMENTARY)
            hits_arr = np.fromiter(hits, dtype=np.int64, count=len(hits))
            cand = (((view["flag"] & excl) == 0)
                    & np.isin(view["pos"].astype(np.int64), hits_arr))
            rows = np.nonzero(cand)[0]
            if not len(rows):
                continue
            offs_c = view["offsets"][rows]
            stats_c = _cigar_stats(view, offs_c)
            seeds_c = hash_lr_batch(stats_c["name_hash"],
                                    stats_c["fnv_hash"]).tolist()
            pos_c = view["pos"][rows].tolist()
            offs_l = offs_c.tolist()
            for k in range(len(offs_l)):
                slices = sr_store[ref_index].get((pos_c[k], seeds_c[k]))
                if slices is None:
                    continue
                rec = view.parse_at(offs_l[k])
                sequence = rec.seq
                readlen = len(sequence)
                for seqsl in slices:
                    svid = seqsl.svid
                    sv = svs[svid]
                    if svcons[svid] or len(seq_store[svid]) >= max_candidates:
                        continue
                    window = cfg.min_cons_window
                    window += max(sv.ciposhigh - sv.ciposlow,
                                  sv.ciendhigh - sv.ciendlow)
                    window += seqsl.inslen
                    orig_center = (readlen - seqsl.sstart
                                   if rec.flag & FREVERSE else seqsl.sstart)
                    s_pos = max(orig_center - window, 0)
                    e_pos = min(orig_center + window, readlen)
                    if e_pos - s_pos <= window:
                        continue
                    anchor_len = orig_center - s_pos
                    sv_side_len = e_pos - orig_center
                    subseq = _orient_subseq(sequence[s_pos:e_pos], sv, rec,
                                            ref_index)
                    seq_store[svid].append(subseq)
                    score_store[svid].append(min(anchor_len, sv_side_len))
                    # Early completion for intra-chromosomal SVs
                    if (not is_translocation(sv.svt)
                            and sv.chr == ref_index
                            and (len(seq_store[svid]) == max_candidates
                                 or len(seq_store[svid]) == sv.srSupport)):
                        ok = False
                        if len(seq_store[svid]) > 1:
                            ok = _run_msa_and_align(
                                cfg, target_lens, seq, None, sv,
                                seq_store[svid], score_store[svid],
                                early=True)
                        if not ok:
                            sv.consensus = ""
                            sv.srSupport = 0
                            sv.srAlignQuality = 0
                        seq_store[svid] = []
                        score_store[svid] = []
                        svcons[svid] = True

        # Left-overs and translocations (assemble.h:882-943)
        for ref_index2 in range(ref_index + 1):
            snd_seq = None
            for svid in range(n_sv):
                if svcons[svid] or len(seq_store[svid]) <= 1:
                    continue
                sv = svs[svid]
                compute = False
                if is_translocation(sv.svt):
                    if (ref_index2 != ref_index and sv.chr == ref_index
                            and sv.chr2 == ref_index2):
                        compute = True
                        if snd_seq is None:
                            snd_seq = fasta.fetch(
                                header.names[ref_index2]).upper()
                else:
                    if (ref_index2 == ref_index and sv.chr == ref_index
                            and sv.chr2 == ref_index2):
                        compute = True
                if compute:
                    ok = _run_msa_and_align(cfg, target_lens, seq, snd_seq,
                                            sv, seq_store[svid],
                                            score_store[svid])
                    if not ok:
                        sv.consensus = ""
                        sv.srSupport = 0
                        sv.srAlignQuality = 0
                    seq_store[svid] = []
                    score_store[svid] = []
                    svcons[svid] = True

    # Clean up unfinished SVs (assemble.h:956-963)
    for svid in range(n_sv):
        if not svcons[svid]:
            svs[svid].consensus = ""
            svs[svid].srSupport = 0
            svs[svid].srAlignQuality = 0


def _assemble_hostaxis(cfg, bams, fasta, valid_regions, svs, sr_store,
                       seq_store, score_store, max_candidates, svcons):
    """Host-axis assemble: per-chromosome read-window collection on the
    interval owner, gate/bookkeeping replayed serially everywhere, and
    the consensus MSA tasks distributed round-robin with the mutated
    SV records exchanged per chromosome.

    Byte-identity argument: the collection applies only row-local
    gates plus a PERMISSIVE per-chromosome candidate cap (the serial
    cap counts across chromosomes, so it trips no later than the local
    one); the replay re-applies the exact svcons/max_candidates gates
    in serial (chromosome, bam, row) order; and the consensus task
    list is a pure function of the replayed bookkeeping (task outcomes
    never gate other SVs), so distributing tasks cannot reorder
    anything."""
    import numpy as np

    from delly_tpu_torch.models.genotype_sr import _cigar_stats
    from delly_tpu_torch.parallel import hostaxis
    from delly_tpu_torch.utils.hashing import hash_lr_batch

    n_sv = len(svs)
    header = bams[0].header
    target_lens = header.lengths
    plan = [ri for ri in range(header.n_targets)
            if valid_regions[ri] and sr_store[ri]]
    owners = {ri: hostaxis.owner_of(k) for k, ri in enumerate(plan)}
    me = hostaxis.process_index()
    nproc = hostaxis.process_count()

    def collect_chrom(ref_index):
        """Ordered (svid, subseq, score) contributions, bam-major; the
        svcons/global-cap gates are left to the replay."""
        local_count = {}
        contrib = []
        hits = {pos for (pos, _seed) in sr_store[ref_index]}
        hits_arr = np.fromiter(hits, dtype=np.int64, count=len(hits))
        for bam in bams:
            view = bam.chrom(ref_index)
            excl = (FQCFAIL | FDUP | FUNMAP | FSECONDARY
                    | FSUPPLEMENTARY)
            cand = (((view["flag"] & excl) == 0)
                    & np.isin(view["pos"].astype(np.int64), hits_arr))
            rows = np.nonzero(cand)[0]
            if not len(rows):
                continue
            offs_c = view["offsets"][rows]
            stats_c = _cigar_stats(view, offs_c)
            seeds_c = hash_lr_batch(stats_c["name_hash"],
                                    stats_c["fnv_hash"]).tolist()
            pos_c = view["pos"][rows].tolist()
            offs_l = offs_c.tolist()
            for k in range(len(offs_l)):
                slices = sr_store[ref_index].get((pos_c[k], seeds_c[k]))
                if slices is None:
                    continue
                rec = view.parse_at(offs_l[k])
                sequence = rec.seq
                readlen = len(sequence)
                for seqsl in slices:
                    svid = seqsl.svid
                    sv = svs[svid]
                    if local_count.get(svid, 0) >= max_candidates:
                        continue
                    window = cfg.min_cons_window
                    window += max(sv.ciposhigh - sv.ciposlow,
                                  sv.ciendhigh - sv.ciendlow)
                    window += seqsl.inslen
                    orig_center = (readlen - seqsl.sstart
                                   if rec.flag & FREVERSE
                                   else seqsl.sstart)
                    s_pos = max(orig_center - window, 0)
                    e_pos = min(orig_center + window, readlen)
                    if e_pos - s_pos <= window:
                        continue
                    anchor_len = orig_center - s_pos
                    sv_side_len = e_pos - orig_center
                    subseq = _orient_subseq(sequence[s_pos:e_pos], sv,
                                            rec, ref_index)
                    contrib.append((svid, subseq,
                                    min(anchor_len, sv_side_len)))
                    local_count[svid] = local_count.get(svid, 0) + 1
        return contrib

    task_slot = [0]  # round-robin consensus-task ownership counter

    def run_task(svid, ref_index, ref_index2, early, seqs, scores,
                 results):
        """Execute one consensus task if owned; mutated SV ships via
        `results`. Non-owners leave the SV untouched (the exchanged
        record replaces it)."""
        slot = task_slot[0]
        task_slot[0] += 1
        if slot % nproc != me:
            return
        sv = svs[svid]
        seq = fasta.fetch(header.names[ref_index]).upper()
        snd_seq = (fasta.fetch(header.names[ref_index2]).upper()
                   if ref_index2 != ref_index else None)
        ok = False
        if len(seqs) > 1:
            ok = _run_msa_and_align(cfg, target_lens, seq, snd_seq, sv,
                                    seqs, scores, early=early)
        if not ok:
            sv.consensus = ""
            sv.srSupport = 0
            sv.srAlignQuality = 0
        results[svid] = sv

    for ref_index in plan:
        contrib = (collect_chrom(ref_index)
                   if owners[ref_index] == me else None)
        contrib = hostaxis.allgather_obj(contrib)[owners[ref_index]]
        results: dict = {}
        for svid, subseq, score in contrib:
            sv = svs[svid]
            if svcons[svid] or len(seq_store[svid]) >= max_candidates:
                continue
            seq_store[svid].append(subseq)
            score_store[svid].append(score)
            # Early completion for intra-chromosomal SVs
            if (not is_translocation(sv.svt) and sv.chr == ref_index
                    and (len(seq_store[svid]) == max_candidates
                         or len(seq_store[svid]) == sv.srSupport)):
                if len(seq_store[svid]) > 1:
                    run_task(svid, ref_index, ref_index, True,
                             seq_store[svid], score_store[svid],
                             results)
                else:
                    sv.consensus = ""
                    sv.srSupport = 0
                    sv.srAlignQuality = 0
                seq_store[svid] = []
                score_store[svid] = []
                svcons[svid] = True

        # Left-overs and translocations (assemble.h:882-943)
        for ref_index2 in range(ref_index + 1):
            for svid in range(n_sv):
                if svcons[svid] or len(seq_store[svid]) <= 1:
                    continue
                sv = svs[svid]
                compute = False
                if is_translocation(sv.svt):
                    if (ref_index2 != ref_index and sv.chr == ref_index
                            and sv.chr2 == ref_index2):
                        compute = True
                else:
                    if (ref_index2 == ref_index and sv.chr == ref_index
                            and sv.chr2 == ref_index2):
                        compute = True
                if compute:
                    run_task(svid, ref_index, ref_index2, False,
                             seq_store[svid], score_store[svid],
                             results)
                    seq_store[svid] = []
                    score_store[svid] = []
                    svcons[svid] = True

        for part in hostaxis.allgather_obj(results):
            for svid, sv in part.items():
                svs[svid] = sv

    # Clean up unfinished SVs (assemble.h:956-963)
    for svid in range(n_sv):
        if not svcons[svid]:
            svs[svid].consensus = ""
            svs[svid].srSupport = 0
            svs[svid].srAlignQuality = 0

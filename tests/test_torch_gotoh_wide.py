"""K4 and K4-tb (profile Gotoh for MSA merges wider than K2's 4,096
columns) of the PyTorch port against the JAX package.

The port's gotoh_batch sends such merges to gotoh_wide_batch, which on
CPU tensors runs the plain forward DP and the plain walk. Its scores and
merged rows must equal the JAX package's host oracle ops.gotoh.gotoh and
its device Gotoh ops.gotoh_device.gotoh_device (X2, run by JAX on the
CPU), and the port's msa_batch on items whose merges pass 4,096 columns
must equal the JAX package's msa_batch. Merges past the widest kernel,
lowercase ones and count-product overflows take the host DP, one host
route each. Inputs come from random.Random(seed); tolerance: exact
equality (integer scores, byte rows, consensus strings).
"""

import random

import numpy as np
import pytest
import torch

import delly_tpu.ops.msa as jmsa
import delly_tpu_torch.ops.msa as tmsa
from delly_tpu.ops.gotoh import DnaScore, gotoh
from delly_tpu.ops.gotoh_device import gotoh_device
from delly_tpu_torch.ops import gotoh_cuda, gotoh_wide_cuda as wide
from delly_tpu_torch.ops.gotoh import DnaScore as TDnaScore
from delly_tpu_torch.ops.gotoh import create_alignment_codes
from delly_tpu_torch.parallel import dispatch
from torch_card import torch_cpu  # noqa: F401

ACS = [(False, False), (True, False), (False, True), (True, True)]
SCHEMES = [(5, -4, -10, -1), (2, -3, -6, -2)]


def _rand_seq(rng, k, alpha="ACGT"):
    return "".join(rng.choice(alpha) for _ in range(k))


def _block(rng, base, rows):
    """An alignment block of `rows` rows over `base`: each row the base
    with 8% of its columns replaced by a letter, or with more than one
    row, a letter or a gap. (A one-row block is a read: the host scores a
    pair of reads on their raw bytes, where a gap would score otherwise
    than in a profile, on the host as in delly_tpu's device Gotoh.)"""
    a = np.repeat(np.frombuffer(base.encode(), np.uint8)[None], rows, 0)
    hit = np.array([[rng.random() < 0.08 for _ in base] for _ in range(rows)])
    subs = _rand_seq(rng, int(hit.sum()), "ACGT-" if rows > 1 else "ACGT")
    a[hit] = np.frombuffer(subs.encode(), np.uint8)
    return a


def _wide_jobs(seed):
    """Profiles of 1-3 rows: a1 of 4,097-4,300 columns against a2 of
    300-4,300: a mutated slice of a1's base, a mutated whole base, and an
    unrelated sequence."""
    rng = random.Random(seed)
    jobs = []
    for kind in ("slice", "whole", "random"):
        base = _rand_seq(rng, rng.randint(4097, 4300))
        if kind == "slice":
            lo = rng.randint(0, 3000)
            other = base[lo:lo + rng.randint(300, 1000)]
        elif kind == "whole":
            other = base[:rng.randint(4000, len(base))]
        else:
            other = _rand_seq(rng, rng.randint(300, 4300))
        jobs.append((_block(rng, base, rng.randint(1, 3)),
                     _block(rng, other, rng.randint(1, 3))))
    assert all(wide.wide_eligible(a1, a2) for a1, a2 in jobs)
    return jobs


def _assert_wide(jobs, ac, scheme, device=False):
    """gotoh_batch through the wide route: 0 host routes, each job equal
    to ops.gotoh.gotoh (and to gotoh_device with `device`)."""
    dispatch.reset()
    got = gotoh_cuda.gotoh_batch(jobs, ac=ac, sc=TDnaScore(*scheme))
    assert dispatch.snapshot()["host_routes"] == 0
    sc = DnaScore(*scheme)
    for (a1, a2), (ds, dm) in zip(jobs, got):
        hs, hm = gotoh(a1, a2, ac=ac, sc=sc)
        assert ds == hs
        np.testing.assert_array_equal(dm, hm)
        if device:
            assert a1.shape[1] * a2.shape[1] <= 1 << 26
            ws, wm = gotoh_device(a1, a2, ac=ac, sc=sc)
            assert ds == ws
            np.testing.assert_array_equal(dm, wm)


@pytest.mark.parametrize("k", range(4))
def test_wide_matches_host(torch_cpu, k):
    """All four end-gap configurations, two under the MSA's scores and
    two under others; at the MSA's configuration (True, True) also
    against the JAX package's device Gotoh (X2, which K4/K4-tb port),
    every job inside its m * n <= 2^26 range."""
    ac, scheme = ACS[k], SCHEMES[k in (1, 2)]
    _assert_wide(_wide_jobs(31 + k), ac, scheme, device=ac == (True, True))


def test_msa_batch_wide_merges(torch_cpu):
    """Two items of three ~4.2 kb reads: every merge passes 4,096
    columns and none is a long pair (each read is shorter than the
    corridor's 8,192), so each round runs K4/K4-tb's plain versions, and
    the consensus equals delly_tpu's msa_batch."""
    rng = random.Random(9)
    items = []
    for _ in range(2):
        base = _rand_seq(rng, 4400)
        seqs = []
        for _ in range(3):
            s = "".join(ch for ch in base if rng.random() > 0.03)
            seqs.append(s[:rng.randint(4150, len(s))])
        items.append((seqs, jmsa.distance_matrix(seqs)))
    want = jmsa.msa_batch([(s, d.copy()) for s, d in items], 2)
    launches = []
    orig = wide.gotoh_wide_forward

    def counted(*args):
        launches.append(args[0].shape)
        return orig(*args)

    dispatch.reset()
    wide.gotoh_wide_forward = counted
    try:
        got = tmsa.msa_batch([(s, d.copy()) for s, d in items], 2)
    finally:
        wide.gotoh_wide_forward = orig
    assert got == want
    assert dispatch.snapshot()["host_routes"] == 0
    assert len(launches) == 2          # one per round, both items in it


def test_host_routes(torch_cpu):
    """Past the widest bucket, lowercase letters, and a count product
    past the gate each take the host DP as one host route, in place;
    beside them a wide merge runs on the wide route."""
    rng = random.Random(4)
    wide_ok = (_block(rng, _rand_seq(rng, 4200), 1),
               _block(rng, _rand_seq(rng, 350), 2))
    jobs = [("A" * (wide.MAX_WIDE + 1), "ACGT"),
            (_rand_seq(rng, 4200).lower(), _rand_seq(rng, 60)),
            wide_ok,
            (np.repeat(np.frombuffer(_rand_seq(rng, 4100).encode(),
                                     np.uint8)[None], 400, 0),
             np.repeat(np.frombuffer(_rand_seq(rng, 20).encode(),
                                     np.uint8)[None], 400, 0))]
    for k, (a1, a2) in enumerate(jobs[:2] + jobs[3:]):
        assert not wide.wide_eligible(*(gotoh_cuda.to_align(x)
                                        for x in (a1, a2))), k
    for k, job in enumerate(jobs):
        dispatch.reset()
        got = gotoh_cuda.gotoh_batch([job], ac=(True, True))
        assert dispatch.snapshot()["host_routes"] == (k != 2)
        hs, hm = gotoh(*job, ac=(True, True))
        assert got[0][0] == hs
        np.testing.assert_array_equal(got[0][1], hm)


@pytest.fixture
def mesh3(torch_cpu):  # noqa: F811
    from delly_tpu_torch.parallel.mesh import make_mesh

    dispatch.reset()
    yield make_mesh(3, devices=[torch.device("cpu")] * 3)
    dispatch.reset()


def test_wide_split_over_mesh(mesh3):
    """Four wide merges (60-90 DP rows against 4,100-4,200 columns) at a
    mesh of 3 CPU devices: the same bytes as without a mesh, and every
    position ran a chunk of the wide engine."""
    rng = random.Random(21)
    jobs = []
    for _ in range(4):
        base = _rand_seq(rng, rng.randint(4100, 4200))
        lo = rng.randint(0, 4000)
        jobs.append((_block(rng, base[lo:lo + rng.randint(60, 90)], 2),
                     _block(rng, base, 1)))
    want = gotoh_cuda.gotoh_batch(jobs, ac=(True, True))
    assert dispatch.device_snapshot() == {}
    with dispatch.use_mesh(mesh3):
        got = gotoh_cuda.gotoh_batch(jobs, ac=(True, True))
    hits = dispatch.device_snapshot()
    assert sorted(hits) == [0, 1, 2]
    assert all(hits[p].get("gotoh_wide", 0) > 0 for p in range(3)), hits
    assert dispatch.snapshot()["host_routes"] == 0
    for (s1, m1), (s2, m2) in zip(want, got):
        assert s1 == s2 and np.array_equal(m1, m2)


@pytest.mark.parametrize("budget,want", [
    (1 << 40, [(0, 5)]),
    (2 * 4100 * 4208, [(0, 2), (2, 4), (4, 5)]),
    (1, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]),
])
def test_chunks_under_budget(budget, want):
    """Launches in job order, each G x M x N bytes of tiles within the
    budget (a merge alone always runs), N a multiple of 16."""
    ms = [4100, 4097, 300, 4100, 16384]
    ns = [4200, 4208, 4100, 4099, 16384]
    assert wide.chunks(ms, ns, budget) == want
    for lo, hi in want:
        M, N = wide.tile_shape(ms[lo:hi], ns[lo:hi])
        assert N % 16 == 0 and N >= max(ns[lo:hi]) and M == max(ms[lo:hi])
        assert hi - lo == 1 or (hi - lo) * M * N <= budget


@pytest.mark.parametrize("M", [1, 4097, 16384])
@pytest.mark.parametrize("N", [16, 64, 128, 4112, 8192, 12208, 16384])
def test_tb_geometry(M, N):
    """K4-tb's layout as the launch takes it: 128 x 128-byte tiles (the
    kernel's, whose 16-byte-aligned boxes a tensor map loads), a ring of
    3 x 3 of them (one buffer a lane of the warp), code rows of M + N
    bytes rounded up to 16 (the kernel's 16-byte stores), and the ring,
    a barrier a buffer and the codes of the widest walk within shared
    memory."""
    tile, side, cstride, smem = wide.tb_geometry(M, N)
    assert (tile, side) == (wide.TB_TILE, wide.TB_SIDE) == (128, 3)
    assert tile % 16 == 0 and side * side <= 32
    assert cstride % 16 == 0 and M + N <= cstride < M + N + 16
    assert cstride <= 2 * wide.MAX_WIDE
    assert smem == side * side * (tile * tile + 8) + 2 * wide.MAX_WIDE
    assert smem <= gotoh_cuda.SMEM_MAX


def test_wrapper_checks():
    """The wrappers refuse tiles K4 does not take (columns not a multiple
    of 16, or wider than 16,384) and a wrong dtype."""
    ok = [torch.zeros(s, dtype=torch.int32)
          for s in ((1, 5, 6), (1, 5, 32), (1, 32), (1,), (1,))]
    with pytest.raises(ValueError):
        wide.gotoh_wide_forward(ok[0], ok[1][:, :, :20].contiguous(),
                                ok[2][:, :20].contiguous(), *ok[3:], True,
                                True, -10, -1)
    with pytest.raises(ValueError):
        wide.gotoh_wide_traceback(torch.zeros((1, 5, 16400),
                                              dtype=torch.uint8), *ok[3:])
    with pytest.raises(TypeError):
        wide.gotoh_wide_forward(ok[0].long(), *ok[1:], True, True, -10, -1)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("N", [4112, 8192, 12208, 16384])
@pytest.mark.parametrize("G", [1, 2, 3, 12, 14, 131, 132, 400])
def test_strip_geometry(G, N, sms):
    """K4's strips: G x P blocks fit the SMs while G < sms, P = 1 from G
    = sms on; W a multiple of 16, at least STRIP_FLOOR; the P strips cover
    N; each block's C chunks at most CHUNK_MAX columns, a multiple of 16,
    and every one of the P x C chunks starts inside the tile."""
    P, W, C = wide.strip_geometry(G, N, sms)
    assert P >= 1 and C >= 1
    if G < sms:
        assert G * P <= sms
    else:
        assert P == 1
    assert W % 16 == 0 and W >= wide.STRIP_FLOOR
    assert P * W >= N
    wc = W // C
    assert wc * C == W and wc % 16 == 0 and wc <= wide.CHUNK_MAX
    assert (P * C - 1) * wc < N


def _strip_model(prof, wc2, d2, ml, nl, hfree, vfree, go, ge, width):
    """K4's strip hand-off in numpy: each merge's DP run strip by strip
    (`width` columns), a strip seeing of the strip to its left only its
    row records (S and R at its last column, and whether H opens at the
    next column), strip 0 taking S[r][0] and R[0] = S[r][0] and opening H
    at column 1; strips wholly past nlen are not run. Returns (best (G,),
    bits (G, M, N)) as gotoh_forward_plain does."""
    G, M, _ = prof.shape
    N = wc2.shape[2]
    ninf = -1_000_000
    best = np.zeros(G, np.int64)
    bits = np.zeros((G, M, N), np.uint8)
    for g in range(G):
        m, n = int(ml[g]), int(nl[g])
        rec = None                       # the records of the strip to the left
        for cs in range(0, N, width):
            if cs >= n:
                break
            cols = np.arange(cs + 1, min(cs + width, N) + 1)   # DP columns
            k = np.arange(len(cols))
            w5 = wc2[g][:, cols - 1].astype(np.int64)
            dd = d2[g][cols - 1].astype(np.int64)
            vf = vfree & (cols == n)
            vo, ve = np.where(vf, 0, go + ge), np.where(vf, 0, ge)
            S = np.zeros(len(cols), np.int64) if hfree else go + cols * ge
            V = np.full(len(cols), ninf, np.int64)
            diag = 0 if cs == 0 or hfree else go + cs * ge     # S[0][cs]
            out = []
            for r in range(1, m + 1):
                O, E = (0, 0) if hfree and r == m else (go + ge, ge)
                p = prof[g, r - 1].astype(np.int64)
                num = p[:5] @ w5
                q = np.abs(num) // np.maximum(p[5] * dd, 1)
                sc = np.where(num < 0, -q, q)
                if cs == 0:
                    s_in = r_in = 0 if vfree else go + r * ge
                    hop_in = 1
                else:
                    s_in, r_in, hop_in = rec[r - 1]
                Vn = np.maximum(S + vo, V + ve)
                t = np.maximum(np.concatenate([[diag], S[:-1]]) + sc, Vn)
                # R[k] = max(R_in + (k + 1) E, max_{k' <= k} t[k'] + (k - k') E)
                R = k * E + np.maximum(r_in + E,
                                       np.maximum.accumulate(t - k * E))
                Rp = np.concatenate([[r_in], R[:-1]])     # R coming in
                H = Rp + O
                Sn = np.maximum(t, H)
                hop = np.concatenate([[hop_in], t[:-1] > Rp[:-1] + E])
                bits[g, r - 1, cols - 1] = (
                    (Sn == H) | (Sn == Vn) << 1 | hop.astype(np.int64) << 2
                    | (Vn != V + ve) << 3)
                out.append((int(Sn[-1]), int(R[-1]),
                            int(t[-1] > Rp[-1] + E)))
                if r == m and cs < n <= cols[-1]:
                    best[g] = Sn[n - cs - 1]
                S, V, diag = Sn, Vn, s_in
            rec = out
    return best, bits


def _strip_jobs(seed, width):
    """Merges in one 60 x 200 tile (N = 208) whose nlen falls on a strip's
    first column, on a strip's last column, with whole strips past it
    (70 and 17 columns), and at the tile's edge."""
    rng = random.Random(seed)
    sizes = [(60, 200), (50, 2 * width + 1), (60, 3 * width), (33, 70),
             (9, 17)]
    jobs = []
    for m, n in sizes:
        base = _rand_seq(rng, max(m, n))
        jobs.append((_block(rng, base[:m], rng.randint(1, 3)),
                     _block(rng, base[:n], rng.randint(1, 3))))
    return jobs


@pytest.mark.parametrize("width", [16, 32, 48])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("ac", ACS)
def test_strip_model_matches_plain(ac, scheme, width):
    """The strip hand-off (_strip_model) gives best and the bits of rows <
    mlen and columns < nlen of gotoh_forward_plain, for all four end-gap
    configurations and both schemes; at the MSA's configuration its walk
    also gives delly_tpu's device Gotoh (ops/gotoh_device.gotoh_device)."""
    jobs = _strip_jobs(width + 7 * len(ac) + scheme[0], width)
    M, N = wide.tile_shape([a.shape[1] for a, _ in jobs],
                           [b.shape[1] for _, b in jobs])
    tsc = TDnaScore(*scheme)
    packed = gotoh_cuda.pack_bucket(jobs, M, tsc, N)
    go, ge = int(tsc.go), int(tsc.ge)
    best, bits = _strip_model(*packed, ac[0], ac[1], go, ge, width)
    want_best, want_bits = gotoh_cuda.gotoh_forward_plain(
        *(torch.from_numpy(x) for x in packed), ac[0], ac[1], go, ge)
    np.testing.assert_array_equal(best, want_best.numpy())
    for g, (m, n) in enumerate(zip(packed[3], packed[4])):
        np.testing.assert_array_equal(bits[g, :m, :n],
                                      want_bits[g, :m, :n].numpy())
    if ac == (True, True) and scheme == SCHEMES[0]:
        codes, lens = gotoh_cuda.gotoh_traceback_plain(
            torch.from_numpy(bits), torch.from_numpy(packed[3]),
            torch.from_numpy(packed[4]))
        for g, (a1, a2) in enumerate(jobs):
            fwd = codes[g, :int(lens[g])].numpy()[::-1].astype(np.int64)
            ws, wm = gotoh_device(a1, a2, ac=ac, sc=DnaScore(*scheme))
            assert int(best[g]) == ws
            np.testing.assert_array_equal(
                create_alignment_codes(fwd, a1, a2), wm)


def _step_table(last):
    """K2-tb's and K4-tb's step table (csrc/gotoh_common.cuh step_table):
    16 entries of 4 bits by a cell's direction bits, bit 0 the column
    steps left, bit 1 the row steps up, bits 2-3 the next state."""
    t = 0
    for b in range(16):
        h = last == 1 or (last == 0 and bool(b & 1))
        v = not h and (last == 2 or (last == 0 and bool(b & 2)))
        nxt = (0 if b & 4 else 1) if h else ((0 if b & 8 else 2) if v else 0)
        t |= (int(not v) | int(not h) << 1 | nxt << 2) << (4 * b)
    return t


def _tb_model(bits, mlen, nlen):
    """K4-tb's tile schedule in numpy (csrc/gotoh_wide_tb.cu), walk by
    walk: on entering tile (tr, tc) buffer k = (kr, kc) of the TB_SIDE x
    TB_SIDE ring takes the window's tile (tr - a, tc - b) of its residues
    where |a - b| <= 1, or a = 0 in a horizontal gap, or b = 0 in a
    vertical one, unless it holds it already; the walk waits for its own
    tile, then reads every byte from the buffer's copy of the tile (zeros
    past the array, as the tensor map's loads give them). Asserts that a
    buffer is taken over only from a tile behind the walk and that each
    byte read lies in a tile that has arrived and was not overwritten.
    Returns (codes (G, M + N) uint8, lens (G,) int32, schedules): a
    schedule per walk, {"fetches": [(step, (r, c), buffer)] in issue
    order, "stalls": [steps at which the walk waited for a tile requested
    at that same entry], "lead": fewest steps between the request of a
    tile requested after the walk's first entry and its first read (None
    if none)}."""
    G, M, N = bits.shape
    T, S = wide.TB_TILE, wide.TB_SIDE
    tables = [_step_table(s) for s in range(3)]
    pad = np.zeros((G, -(-M // T) * T, -(-N // T) * T), np.uint8)
    pad[:, :M, :N] = bits
    codes = np.zeros((G, M + N), np.uint8)
    lens = np.zeros(G, np.int32)
    schedules = []
    for g in range(G):
        m, n = min(max(int(mlen[g]), 0), M), min(max(int(nlen[g]), 0), N)
        tag = [None] * (S * S)
        busy = [False] * (S * S)
        buf = [None] * (S * S)
        asked = {}                       # tile: step of its request
        sched = {"fetches": [], "stalls": [], "lead": None}
        row, col, last, out = m, n, 0, []
        while row > 0 and col > 0:
            tr, tc = (row - 1) // T, (col - 1) // T
            issued = set()
            for k in range(S * S):
                kr, kc = divmod(k, S)
                a, b = (tr - kr) % S, (tc - kc) % S
                r, c = tr - a, tc - b
                want = r >= 0 and c >= 0 and (
                    abs(a - b) <= 1 or (a == 0 and last == 1)
                    or (b == 0 and last == 2))
                if want and tag[k] != (r, c):
                    assert tag[k] is None or (tag[k][0] > tr
                                              or tag[k][1] > tc), (
                        "a buffer taken from a tile the walk may enter")
                    tag[k], busy[k] = (r, c), True
                    buf[k] = pad[g, r * T:(r + 1) * T, c * T:(c + 1) * T]
                    sched["fetches"].append((len(out), (r, c), k))
                    asked[(r, c)] = len(out)
                    issued.add(k)
            q = (tr % S) * S + tc % S
            assert tag[q] == (tr, tc)
            if busy[q]:
                if q in issued:
                    sched["stalls"].append(len(out))
                elif asked[(tr, tc)] > 0:
                    lead = len(out) - asked[(tr, tc)]
                    sched["lead"] = (lead if sched["lead"] is None
                                     else min(sched["lead"], lead))
                busy[q] = False
            r0, c0 = tr * T, tc * T
            while True:
                assert tag[q] == (tr, tc) and not busy[q]
                byte = int(buf[q][row - 1 - r0, col - 1 - c0])
                e = tables[last] >> (4 * (byte & 15)) & 15
                dc, dr = e & 1, (e >> 1) & 1
                last = e >> 2
                out.append(0 if dr and dc else (2 if dr else 1))
                col -= dc
                row -= dr
                if not (row > r0 and col > c0):
                    break
        # row 0 or column 0: no bits read; as the plain walk, at most M + N
        # codes (a valid walk stops at mlen + nlen)
        while (row > 0 or col > 0) and len(out) < M + N:
            if last == 0:
                last = 1 if row == 0 else 2
            elif last == 1:
                if row == 0 and col == 1:
                    last = 0
                col -= 1
                out.append(1)
            else:
                if col == 0 and row == 1:
                    last = 0
                row -= 1
                out.append(2)
        codes[g, :len(out)] = out
        lens[g] = len(out)
        schedules.append(sched)
    return codes, lens, schedules


def _gap_jobs(seed):
    """Merges in one jagged tile whose walks cross K4-tb's 128-byte tiles:
    a horizontal and a vertical gap of 300-380 columns or rows (longer
    than two tiles) inside mutated copies, a short profile against a
    long one (end gaps, and a walk that ends on row 0 or column 0 or,
    with free end gaps, runs along one), mlen and nlen of 1 beside wide
    ones, and a mutated copy with substitutions only; lengths not
    multiples of 16."""
    rng = random.Random(seed)
    base = _rand_seq(rng, 1200)
    cut = rng.randint(300, 380)
    lo = rng.randint(350, 500)
    jobs = [(base[:730], base[:lo] + base[lo + cut:730]),     # gap in a2
            (base[:lo] + base[lo + cut:737], base[:737]),     # gap in a1
            (base[100:390], base[:1011]),                     # a1 inside a2
            (base[:923], base[350:589]),                      # a2 inside a1
            (base[600:601], base[:633]), (base[:551], base[400:401]),
            (base[5:1182], base[5:1182])]
    out = []
    for k, (x, y) in enumerate(jobs):
        rows = (1, 2, 3)[k % 3]
        out.append((_block(rng, x, rows), _block(rng, y, 1 + k % 2)))
    return out


def _model_case(jobs, ac, scheme):
    """The jobs packed into one tile, K4's plain forward run on it, and
    the plain walk and the schedule model on its bits."""
    M, N = wide.tile_shape([a.shape[1] for a, _ in jobs],
                           [b.shape[1] for _, b in jobs])
    tsc = TDnaScore(*scheme)
    packed = gotoh_cuda.pack_bucket(jobs, M, tsc, N)
    go, ge = int(tsc.go), int(tsc.ge)
    t = [torch.from_numpy(x) for x in packed]
    _best, bits = gotoh_cuda.gotoh_forward_plain(*t, ac[0], ac[1], go, ge)
    want_codes, want_lens = gotoh_cuda.gotoh_traceback_plain(bits, t[3],
                                                             t[4])
    codes, lens, scheds = _tb_model(bits.numpy(), packed[3], packed[4])
    return packed, want_codes.numpy(), want_lens.numpy(), codes, lens, scheds


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("ac", ACS)
def test_tb_model_matches_plain(ac, scheme):
    """K4-tb's tile schedule (_tb_model) gives the lengths and codes of
    gotoh_traceback_plain on walks with gaps longer than two tiles, walks
    ending on row 0 or column 0, mlen < M, nlen < N, lengths off 16, and
    M != N, for all four end-gap configurations and both schemes; every
    byte read from a tile that had arrived and was not overwritten, and
    the walk waits only for its first tile (every later one was requested
    at an earlier entry). At the MSA's configuration its walks also give
    delly_tpu's device Gotoh (ops/gotoh_device.gotoh_device)."""
    jobs = _gap_jobs(3 * len(ac) + scheme[0] + 5 * ac[0] + 7 * ac[1])
    packed, want_codes, want_lens, codes, lens, scheds = _model_case(
        jobs, ac, scheme)
    M, N = packed[0].shape[1], packed[1].shape[2]
    assert M != N and any(x % 16 for x in packed[4])
    np.testing.assert_array_equal(lens, want_lens)
    for g in range(len(jobs)):
        np.testing.assert_array_equal(codes[g, :lens[g]],
                                      want_codes[g, :lens[g]])
        assert scheds[g]["stalls"] == ([0] if scheds[g]["fetches"] else [])
    # the cases hold: a horizontal and a vertical run of moves longer
    # than two tiles, and a walk whose last move is along row 0 or column
    # 0 (a move that is no diagonal)
    runs = {1: 0, 2: 0}
    for g in range(len(jobs)):
        walk = codes[g, :lens[g]].tolist()
        k = 0
        while k < len(walk):
            j = k
            while j < len(walk) and walk[j] == walk[k]:
                j += 1
            if walk[k]:
                runs[walk[k]] = max(runs[walk[k]], j - k)
            k = j
    assert min(runs.values()) > 2 * wide.TB_TILE, runs
    assert any(codes[g, lens[g] - 1] for g in range(len(jobs)))
    if ac == (True, True) and scheme == SCHEMES[0]:
        for g, (a1, a2) in enumerate(jobs):
            fwd = codes[g, :lens[g]][::-1].astype(np.int64)
            _ws, wm = gotoh_device(a1, a2, ac=ac, sc=DnaScore(*scheme))
            np.testing.assert_array_equal(
                create_alignment_codes(fwd, a1, a2), wm)


@pytest.mark.parametrize("seed", range(3))
def test_tb_model_prefetches_ahead(seed):
    """On walks of mutated copies (substitutions only, as most of the
    MSA's long merges) the schedule holds no walk for a load it could
    have started earlier: it waits only for its first tile, and every
    tile requested after the first entry is requested at least a tile's
    side of steps before the walk reads it."""
    rng = random.Random(100 + seed)
    jobs = []
    for k in range(3):
        base = _rand_seq(rng, rng.randint(500, 800))
        lo = rng.randint(0, 40)
        jobs.append((_block(rng, base, 1 + k % 2),
                     _block(rng, base[lo:], 1 + (k + 1) % 2)))
    packed, want_codes, want_lens, codes, lens, scheds = _model_case(
        jobs, (False, False), SCHEMES[0])
    np.testing.assert_array_equal(lens, want_lens)
    for g, s in enumerate(scheds):
        np.testing.assert_array_equal(codes[g, :lens[g]],
                                      want_codes[g, :lens[g]])
        assert s["stalls"] == [0]
        assert s["lead"] is not None and s["lead"] >= wide.TB_TILE

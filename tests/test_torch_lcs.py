"""X1, the MSA's batched LCS, in the PyTorch port on the host.

ops/lcs_cuda.lcs runs its plain version (ops/msa.py lcs_plain) on CPU
tensors; both must equal the JAX package's LCS (delly_tpu.ops.msa.lcs
pair by pair and lcs_pairs on the batch) and the port's host
bit-parallel native.lcs_many, on seeded numpy batches: empty strings,
lengths at 64-bit word boundaries, a padded batch mixing 2 kb and 100 b
pairs, N letters, homopolymers (carries across every word), letters
that b lacks, 60 letters, long a against short b and the reverse.
Tolerance: exact equality (integer lengths). The
kernel itself (csrc/lcs.cu) runs only on the card:
tests/test_torch_cuda.py holds it to lcs_plain there.
"""

import os
import re

import numpy as np
import pytest
import torch

import delly_tpu.ops.msa as jmsa
import delly_tpu_torch.ops.msa as tmsa
from delly_tpu_torch import native
from delly_tpu_torch.ops import lcs_cuda
from delly_tpu_torch.parallel import dispatch
from torch_card import torch_cpu  # noqa: F401

EDGES = (0, 1, 63, 64, 65, 127, 128, 129)


def _mutate(rng, s, letters):
    """5% substitutions, 4% deletions, 3% insertions."""
    out = []
    for ch in s:
        r = rng.random()
        if r < 0.04:
            continue
        out.append(letters[rng.integers(len(letters))] if r < 0.09 else ch)
        if rng.random() < 0.03:
            out.append(letters[rng.integers(len(letters))])
    return "".join(out)


def _pairs(seed, lengths, letters="ACGT"):
    """(a, b) pairs: b a mutated copy of a's base for every other pair,
    unrelated for the rest; a and b cut to the given lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for k, (m, n) in enumerate(lengths):
        base = "".join(letters[i] for i in rng.integers(0, len(letters),
                                                         max(m, n) + 8))
        other = (_mutate(rng, base, letters) if k % 2 == 0 else
                 "".join(letters[i] for i in rng.integers(
                     0, len(letters), n + 8)))
        out.append((base[:m], other[:n]))
    return out


CASES = {
    "empty and word edges": [(m, n) for m in EDGES for n in EDGES],
    "2 kb and 100 b in one batch": [(2000, 2100), (100, 90), (1990, 2048),
                                    (64, 2000), (2000, 100), (120, 100),
                                    (2047, 1999)],
    "N letters": [(150, 150)] * 6 + [(129, 65), (65, 129)],
    "homopolymers": [(200, 200), (1, 129), (129, 1), (300, 64), (64, 300)],
    "letters b lacks": [(150, 150)] * 4 + [(300, 65), (65, 300)],
    "60 letters": [(300, 700), (700, 300), (65, 65), (128, 129)],
    "deepgeno's ~150 b split reads": [(140 + i % 21, 150 - i % 17)
                                      for i in range(40)],
    "long a, short b, and the reverse": [(3000, 64), (64, 3000), (3000, 1),
                                         (1, 3000), (2500, 129)],
    # the kernel's layouts (lcs_cuda.LAYOUTS) at their edges: one thread
    # per pair for b of 64 K and 64 K + 1 bases, K = 1 ... 4 words, and
    # lane groups for b of G x K x 64 bases and one more or less
    "thread-layout edges": [(40 + 7 * k, 64 * k + d) for k in (1, 2, 3, 4)
                            for d in (0, 1)],
    "lane-group edges": [(30 + w % 23, 64 * w + d) for w in (8, 16, 32, 64)
                         for d in (-1, 1)],
}
LETTERS = {"N letters": "ACGTN", "homopolymers": "A",
           "60 letters": "".join(chr(c) for c in range(40, 100))}


def _case_pairs(case, seed):
    pairs = _pairs(seed, CASES[case], LETTERS.get(case, "ACGT"))
    if case == "letters b lacks":
        # b holds A and C only: rows of a at G and T leave V as it is
        pairs = [(a, b.replace("G", "A").replace("T", "C"))
                 for a, b in pairs]
    return pairs


def _pack(pairs):
    nb = len(pairs)
    m = max(1, max(len(a) for a, _ in pairs))
    n = max(1, max(len(b) for _, b in pairs))
    a = np.zeros((nb, m), dtype=np.uint8)
    b = np.zeros((nb, n), dtype=np.uint8)
    for i, (x, y) in enumerate(pairs):
        a[i, :len(x)] = np.frombuffer(x.encode(), dtype=np.uint8)
        b[i, :len(y)] = np.frombuffer(y.encode(), dtype=np.uint8)
    al = np.array([len(x) for x, _ in pairs], dtype=np.int32)
    bl = np.array([len(y) for _, y in pairs], dtype=np.int32)
    return a, al, b, bl


@pytest.mark.parametrize("case", list(CASES))
def test_lcs_matches_jax_and_native(case):
    pairs = _case_pairs(case, len(case))
    want = np.array([jmsa.lcs(a, b) for a, b in pairs], dtype=np.int64)
    a, al, b, bl = _pack(pairs)
    plain = tmsa.lcs_plain(*(torch.from_numpy(x) for x in (a, al, b, bl)))
    np.testing.assert_array_equal(plain.numpy(), want)
    lut, nalpha = lcs_cuda.letter_lut(b, bl)
    dispatch.reset()
    got = lcs_cuda.lcs(*(torch.from_numpy(x) for x in (a, al, b, bl, lut)),
                       nalpha)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert dispatch.snapshot()["lcs"] == 0
    np.testing.assert_array_equal(native.lcs_many(a, al, b, bl), want)
    np.testing.assert_array_equal(jmsa.lcs_pairs(pairs), want)


@pytest.mark.parametrize("case", list(CASES))
def test_lcs_pairs_matches_jax(case, torch_cpu):  # noqa: F811
    pairs = _case_pairs(case, len(case) + 1)
    dispatch.reset()
    got = tmsa.lcs_pairs(pairs)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jmsa.lcs_pairs(pairs))
    # on the host the wrapper runs the plain version: no kernel launch
    assert dispatch.snapshot()["lcs"] == 0


def test_letter_lut_codes_only_b():
    """b's letters within its lengths are coded 0..nalpha-1 in byte
    order; padding and letters that only a or b's tail hold are not."""
    b = np.frombuffer(b"GATTxNNN" b"CAAAAAAA", dtype=np.uint8).reshape(2, 8)
    lut, nalpha = lcs_cuda.letter_lut(b, np.array([4, 2], dtype=np.int32))
    assert nalpha == 4
    coded = {chr(i): int(lut[i]) for i in range(256)
             if lut[i] != lcs_cuda.ABSENT}
    assert coded == {"A": 0, "C": 1, "G": 2, "T": 3}
    lut, nalpha = lcs_cuda.letter_lut(b[:, :0], np.zeros(2, np.int32))
    assert nalpha == 0 and (lut == lcs_cuda.ABSENT).all()


def test_letter_lut_many_letters():
    """Every byte that b holds within its lengths gets its own code, up
    to all 256; a byte only a holds stays ABSENT."""
    b = np.arange(256, dtype=np.uint8).reshape(2, 128)
    lut, nalpha = lcs_cuda.letter_lut(b, np.array([128, 100], np.int32))
    assert nalpha == 228
    assert (lut[:228] == np.arange(228)).all()
    assert (lut[228:] == lcs_cuda.ABSENT).all()
    lut, nalpha = lcs_cuda.letter_lut(b, np.array([128, 128], np.int32))
    assert nalpha == 256 and (lut == np.arange(256)).all()


def test_lcs_refuses_other_devices():
    """A tensor that is on neither the host nor a card is refused, not
    sent to the plain version."""
    a = torch.zeros((2, 5), dtype=torch.uint8, device="meta")
    ln = torch.zeros(2, dtype=torch.int32, device="meta")
    lut = torch.zeros(256, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lcs_cuda.lcs(a, ln, a, ln, lut, 0)


def test_lcs_empty_batch():
    """A batch of no pairs gives no lengths, and strings of no bytes
    give 0."""
    z = torch.zeros((0, 4), dtype=torch.uint8)
    e = torch.zeros(0, dtype=torch.int32)
    lut = torch.full((256,), lcs_cuda.ABSENT, dtype=torch.uint8)
    assert lcs_cuda.lcs(z, e, z, e, lut, 0).tolist() == []
    a = torch.zeros((3, 0), dtype=torch.uint8)
    n = torch.zeros(3, dtype=torch.int32)
    assert lcs_cuda.lcs(a, n, a, n, lut, 0).tolist() == [0, 0, 0]
    assert tmsa.lcs_pairs([]).tolist() == []


def test_lcs_checks_its_inputs():
    a = torch.zeros((2, 5), dtype=torch.uint8)
    b = torch.zeros((2, 7), dtype=torch.uint8)
    ln = torch.full((2,), 5, dtype=torch.int32)
    lut = torch.zeros(256, dtype=torch.uint8)
    with pytest.raises(TypeError):
        lcs_cuda.lcs(a.int(), ln, b, ln, lut, 1)
    with pytest.raises(ValueError):
        lcs_cuda.lcs(a, ln[:1], b, ln, lut, 1)
    with pytest.raises(ValueError):
        lcs_cuda.lcs(a, ln, b[:1], ln, lut, 1)
    with pytest.raises(ValueError):
        lcs_cuda.lcs(a, ln, b, ln, lut, 257)
    # lut codes b's byte 0 as 0, which nalpha 0 leaves out
    with pytest.raises(ValueError):
        lcs_cuda.lcs(a, ln, b, ln, lut, 0)
    assert lcs_cuda.lcs(a, ln, b, ln, lut, 1).tolist() == [5, 5]


def test_layouts_match_kernel_source():
    """The wrapper's layout table, strip width and shared-memory budget
    are the kernel's (csrc/lcs.cu kG, kK, kStripWords, kSmemMasks)."""
    src = open(os.path.join(os.path.dirname(lcs_cuda.__file__), "..", "csrc",
                            "lcs.cu")).read()

    def table(name):
        body = re.search(rf"{name}\[kLayouts\] = {{([^}}]*)}}", src).group(1)
        return [int(v) for v in body.split(",")]

    assert list(zip(table("kG"), table("kK"))) == list(lcs_cuda.LAYOUTS)
    assert int(re.search(r"kLayouts = (\d+);", src).group(1)) == len(
        lcs_cuda.LAYOUTS)
    assert re.search(r"kStripWords = 32 \* 8;", src)
    assert lcs_cuda.STRIP_WORDS == 32 * 8
    assert re.search(r"kSmemMasks = 64 \* 1024;", src)
    assert lcs_cuda.SMEM_MASKS == 64 * 1024


SCHEDULES = {
    # long-split's 96-pair mix: ~12 kb pairs beside ~150 b ones
    "long-split mix": ([11_800 + 13 * i for i in range(48)]
                       + [150 - i % 9 for i in range(48)],
                       [12_300 - 11 * i for i in range(48)]
                       + [140 + i % 13 for i in range(48)]),
    "every layout and empty": ([5 * i % 97 for i in range(300)],
                               [(i * 131) % 20_000 for i in range(300)]),
    "one layout": ([100 - i % 17 for i in range(1000)],
                   [100 - i % 13 for i in range(1000)]),
    "no pairs": ([], []),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_groups_pairs_by_layout(case):
    """Each pair gets one slot and one layout that holds its b; the
    segments cover the slots in order, one layout each, widest first;
    within a segment a's lengths fall, so no warp mixes a long pair with
    short ones; and the order, undone, gives back the caller's pairs."""
    al = np.array(SCHEDULES[case][0], dtype=np.int32)
    bl = np.array(SCHEDULES[case][1], dtype=np.int32)
    order, segs = lcs_cuda.schedule(al, bl)
    assert sorted(order.tolist()) == list(range(len(al)))
    restored = np.empty_like(order)
    restored[order] = np.arange(len(al))
    assert (order[restored] == np.arange(len(al))).all()
    lay = lcs_cuda.layout_of(bl)
    slot = 0
    for k, (layout, first, count) in enumerate(segs):
        assert first == slot and count >= 1
        assert k == 0 or layout < segs[k - 1][0]
        pairs = order[first:first + count]
        assert (lay[pairs] == layout).all()
        g, kw = lcs_cuda.LAYOUTS[layout]
        words = (bl[pairs] + 63) // 64
        assert (words <= g * kw).all() or layout == len(lcs_cuda.LAYOUTS) - 1
        assert layout == 0 or (words > np.prod(
            lcs_cuda.LAYOUTS[layout - 1])).all()
        assert (np.diff(al[pairs]) <= 0).all()
        for w in range(0, count, 32 // g):   # one warp's pairs
            held = bl[pairs[w:w + 32 // g]]
            assert held.max() < 4 * max(held.min(), 64)
        slot += count
    assert slot == len(al)
    assert lcs_cuda.warps_of(segs) == sum(
        -(-c // (32 // lcs_cuda.LAYOUTS[lay_][0])) for lay_, _f, c in segs)
    if case == "long-split mix":
        # 32 lanes of 8 and of 6 words a pair; 3-word threads, 32 a warp
        assert [s_[:3:2] for s_ in segs] == [(10, 2), (9, 46), (2, 48)]
        assert lcs_cuda.warps_of(segs) == 48 + 2


def test_host_lengths_checked_in_place():
    """host_lengths stand in for the tensors' lengths: their shapes must
    be the tensors', b's must lie in [0, N]; the CPU path then runs as
    without them. A wrong length is found without the tensors' values."""
    pairs = _case_pairs("N letters", 3)
    a, al, b, bl = _pack(pairs)
    lut, nalpha = lcs_cuda.letter_lut(b, bl)
    t = [torch.from_numpy(x) for x in (a, al, b, bl, lut)]
    want = lcs_cuda.lcs(*t, nalpha)
    got = lcs_cuda.lcs(*t, nalpha, host_lengths=(al, bl))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="host_lengths"):
        lcs_cuda.lcs(*t, nalpha, host_lengths=(al[:-1], bl))
    with pytest.raises(ValueError, match="host_lengths"):
        lcs_cuda.lcs(*t, nalpha, host_lengths=(al, bl[:, None]))
    over = bl.copy()
    over[2] = b.shape[1] + 1
    with pytest.raises(ValueError, match="b lengths"):
        lcs_cuda.lcs(*t, nalpha, host_lengths=(al, over))
    # the check reads the host arrays, not the tensors
    lengths = lcs_cuda._lengths(t[0], t[1], t[2], t[3], (al, bl))
    assert lengths[0] is al and lengths[1] is bl
    assert lengths[2] == (int(bl.min()), int(bl.max()))

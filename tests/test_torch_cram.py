"""The PyTorch port's CRAM input against the JAX package.

io/cram.py and its codecs (io/rans_nx16.py, io/tok3.py, io/fqzcomp.py,
io/arith_nx.py) are copies of the JAX package's. On seeded corpora and
on generated BAMs (tests/bamsynth.py; never the reference's example
data), the port must give the JAX package's bytes:

- every codec's encoded and decoded bytes: rANS 4x8 order 0 and 1,
  rANS Nx16 under every flag set of tests/test_rans_nx16.py, tok3,
  fqzcomp and the adaptive arithmetic codec;
- ``write_cram`` of a mixed-SV BAM as CRAM 3.0 with rANS, 3.0 gzip-only,
  3.1, and 3.1 with fqzcomp qualities: the file byte for byte (one
  reference), and its records read back by the port equal to the BAM's
  (one reference, and two with a slice across both: the port's writer
  differs from the JAX package's there, ROADMAP section 3);
- `sr` on the CRAM through the port's CLI (DELLY_TPU_TORCH_DEVICE=cpu),
  whole-file and streaming: equal to the port's `sr` on the BAM and to
  the JAX package's `sr` on the CRAM (the check of
  tests/test_streaming.py and tests/test_cram.py on generated data);
- `lr` on a CRAM of the long-read SV families, likewise;
- `cnv`'s mapped-read estimate on a streaming CRAM, which has no index.
"""

import json
import os
import random
import struct
import subprocess
import sys
import uuid

import numpy as np
import pytest

from bamsynth import make_lr_sv_dataset, make_multi_sv_dataset
from torch_card import output_lines, run_cli

import delly_tpu.io.arith_nx as jax_ax
import delly_tpu.io.cram as jax_cram
import delly_tpu.io.fqzcomp as jax_fz
import delly_tpu.io.rans_nx16 as jax_rx
import delly_tpu.io.tok3 as jax_tok3
import delly_tpu_torch.io.arith_nx as ax
import delly_tpu_torch.io.cram as cram
import delly_tpu_torch.io.fqzcomp as fz
import delly_tpu_torch.io.rans_nx16 as rx
import delly_tpu_torch.io.tok3 as tok3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpora():
    rng = random.Random(41)
    return {
        "dna": bytes(rng.choice(b"ACGT") for _ in range(5000)),
        "quals": bytes(rng.choice(b"##,,FFFF:") for _ in range(4000)),
        "runs": b"".join(bytes([rng.randrange(5)]) * rng.randrange(1, 40)
                         for _ in range(300)),
        "all": bytes(rng.randrange(256) for _ in range(3000)),
        "skew": bytes(rng.choices(range(8), weights=[100, 50, 20, 8, 4, 2,
                                                     1, 1])[0]
                      for _ in range(6000)),
        "odd": bytes(rng.choice(b"ACGTN") for _ in range(1023)),
        "tiny": b"A",
        "pair": b"AB",
    }


def _rans4x8_order1(raw: bytes) -> bytes:
    """An order-1 rANS 4x8 stream of `raw` in the layout both packages'
    decoders read (htscodecs rans_static): the outer table of contexts,
    one order-0 table each, and four states over the four quarters of
    the data, the fourth also taking the remainder. Neither package
    writes order 1, so the test writes it here."""
    n = len(raw)
    q = n >> 2
    starts = [0, q, 2 * q, 3 * q]
    ctx = [0] * n
    for j in range(4):
        end = n if j == 3 else starts[j] + q
        for p in range(starts[j] + 1, end):
            ctx[p] = raw[p - 1]
    counts = np.zeros((256, 256), dtype=np.int64)
    for p in range(n):
        counts[ctx[p], raw[p]] += 1
    ctxs = sorted(set(ctx))
    freqs = {c: cram._normalize_freqs(counts[c]) for c in ctxs}
    table = bytearray()
    rle = 0
    for k, c in enumerate(ctxs):
        if rle > 0:
            rle -= 1
        else:
            table.append(c)
            if k > 0 and c == ctxs[k - 1] + 1:
                run = 0
                while (k + run + 1 < len(ctxs)
                       and ctxs[k + run + 1] == c + run + 1):
                    run += 1
                table.append(run)
                rle = run
        table += cram._write_freq_table0(freqs[c])
    table.append(0)
    fstart = {c: np.concatenate(([0], np.cumsum(freqs[c])[:-1]))
              for c in ctxs}
    # the decoder's order, reversed: the remainder, then the quarters
    order = [(p, 3) for p in range(n - 1, 4 * q - 1, -1)]
    order += [(starts[j] + i, j) for i in range(q - 1, -1, -1)
              for j in (3, 2, 1, 0)]
    states = [cram.RANS_L] * 4
    out_rev = bytearray()
    for p, j in order:
        s, c = raw[p], ctx[p]
        f = int(freqs[c][s])
        x = states[j]
        xmax = ((cram.RANS_L >> cram.TF_SHIFT) << 8) * f
        while x >= xmax:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << cram.TF_SHIFT) + (x % f) + int(fstart[c][s])
    payload = (bytes(table) + struct.pack("<4I", *states)
               + bytes(reversed(out_rev)))
    return struct.pack("<BII", 1, len(payload), n) + payload


@pytest.mark.parametrize("name", sorted(_corpora()))
def test_rans4x8_matches_jax(name):
    data = _corpora()[name]
    enc = cram.rans_encode_order0(data)
    assert enc == jax_cram.rans_encode_order0(data)
    assert cram.rans_decode(enc) == jax_cram.rans_decode(enc) == data
    enc1 = _rans4x8_order1(data)
    assert cram.rans_decode(enc1) == jax_cram.rans_decode(enc1) == data
    assert (cram._rans_decode_order1(enc1, 9, len(data))
            == jax_cram._rans_decode_order1(enc1, 9, len(data)))


RANS_NX16_FLAGS = [
    0,
    rx.F_ORDER1,
    rx.F_CAT,
    rx.F_RLE,
    rx.F_PACK,
    rx.F_PACK | rx.F_RLE,
    rx.F_RLE | rx.F_ORDER1,
    rx.F_PACK | rx.F_ORDER1,
    rx.F_PACK | rx.F_RLE | rx.F_ORDER1,
    rx.F_X32,
    rx.F_X32 | rx.F_ORDER1,
    rx.F_STRIPE,
    rx.F_STRIPE | rx.F_ORDER1,
    rx.F_NOSZ,
    rx.F_RLE | rx.F_CAT,
]


def _codec_matches(port, jax, flags):
    for name, data in _corpora().items():
        if flags & rx.F_PACK and len(set(data)) > 16:
            continue
        enc = port.encode(data, flags)
        assert enc == jax.encode(data, flags), (name, flags)
        out_sz = len(data) if flags & rx.F_NOSZ else None
        got, want = port.decode(enc, out_sz), jax.decode(enc, out_sz)
        assert got == want and got[0] == data, (name, flags)


@pytest.mark.parametrize("flags", RANS_NX16_FLAGS)
def test_rans_nx16_matches_jax(flags):
    _codec_matches(rx, jax_rx, flags)


@pytest.mark.parametrize("flags", [
    0, rx.F_ORDER1, rx.F_CAT, rx.F_RLE, rx.F_PACK, rx.F_PACK | rx.F_RLE,
    rx.F_RLE | rx.F_ORDER1, rx.F_PACK | rx.F_ORDER1, rx.F_STRIPE,
    rx.F_STRIPE | rx.F_ORDER1, rx.F_NOSZ])
def test_arith_matches_jax(flags):
    _codec_matches(ax, jax_ax, flags)


def _names():
    rng = random.Random(7)
    illumina = [f"A01234:{rng.randint(1, 99)}:HGXXXDSX:{rng.randint(1, 4)}:"
                f"{1000 + i // 3}:{rng.randint(1000, 99999)}:"
                f"{rng.randint(1000, 99999)}".encode() for i in range(300)]
    ont = [str(uuid.UUID(int=rng.getrandbits(128))).encode()
           for _ in range(100)]
    sra = [f"SRR1234567.{i + 1}".encode() for i in range(300)]
    odd = [b"x", b"0", b"00", b"0001", b"a0b00c000", b"read_0009",
           b"read_0010", b"read_0010", b"r" + b"9" * 30]
    odd += [bytes(rng.choice(b"abcXYZ0123:_-.#")
                  for _ in range(rng.randint(1, 40))) for _ in range(40)]
    return {"illumina": illumina, "ont": ont, "sra": sra, "odd": odd}


@pytest.mark.parametrize("name", ["illumina", "ont", "sra", "odd"])
def test_tok3_matches_jax(name):
    names = _names()[name]
    enc = tok3.encode(names)
    assert enc == jax_tok3.encode(names)
    assert tok3.decode(enc) == jax_tok3.decode(enc)
    assert tok3.decode(enc).split(b"\0")[:len(names)] == names


def _quals():
    rng = random.Random(3)
    out = []
    for _ in range(60):
        cur, q = rng.choice(b"#,:F"), bytearray()
        for _ in range(150):
            if rng.random() < 0.07:
                cur = rng.choice(b"#,:F")
            q.append(cur)
        out.append(bytes(q))
    for _ in range(8):
        cur, q = 20, bytearray()
        for _ in range(rng.randint(200, 3000)):
            cur = min(50, max(1, cur + rng.randint(-2, 2)))
            q.append(cur + 33)
        out.append(bytes(q))
    return out


def test_fqzcomp_matches_jax():
    quals = _quals()
    enc = fz.encode(quals)
    assert enc == jax_fz.encode(quals)
    lens = [len(q) for q in quals]
    assert fz.decode(enc, lens) == jax_fz.decode(enc, lens) == quals


@pytest.fixture(scope="module")
def srdata(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cram")
    bam, fa, truth = make_multi_sv_dataset(str(d), n_contigs=2,
                                           contig_len=200_000,
                                           pairs_per_contig=3000)
    os.makedirs(d / "one")
    one = make_multi_sv_dataset(str(d / "one"), n_contigs=1,
                                contig_len=200_000, pairs_per_contig=3000)
    return d, bam, fa, truth, one


WRITES = {
    "3.0 rans": dict(),
    "3.0 gzip": dict(use_rans=False),
    "3.1": dict(version=(3, 1)),
    "3.1 fqz": dict(version=(3, 1), use_fqz=True),
}


def _records_equal(bam_path, cram_path, fa):
    from delly_tpu_torch.io.bam import BamFile

    bam = BamFile(bam_path)
    cr = BamFile(cram_path, genome=fa)
    a, b = bam.core_index(), cr.core_index()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    n = 0
    for x, y in zip(bam.records(), cr.records()):
        assert x.qname == y.qname
        assert x.cigar_string() == y.cigar_string()
        assert x.seq == y.seq
        assert bytes(x.qual) == bytes(y.qual)
        assert bytes(x._aux) == bytes(y._aux)
        n += 1
    assert n == len(a["pos"]) > 0


def _ref_ids(path, fa):
    """The reference id of each container (-2: several references)."""
    cs = cram.CramStream(path, fa)
    try:
        return [c[2] for c in cs.containers]
    finally:
        cs.close()


@pytest.mark.parametrize("kind", list(WRITES))
def test_write_cram_matches_jax(srdata, kind, monkeypatch):
    """A BAM of one reference: the port's file equals the JAX package's
    byte for byte (both written at one clock reading: a gzip block's
    header holds its write time), and its records equal the BAM's."""
    import time

    from delly_tpu.io.bam import BamFile as JaxBam
    from delly_tpu_torch.io.bam import BamFile

    d, _bam, _fa, _truth, (bam, fa, _t) = srdata
    stem = kind.replace(" ", "_")
    port, jax = str(d / f"{stem}.port.cram"), str(d / f"{stem}.jax.cram")
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    cram.write_cram(BamFile(bam), fa, port, **WRITES[kind])
    jax_cram.write_cram(JaxBam(bam), fa, jax, **WRITES[kind])
    monkeypatch.undo()
    with open(port, "rb") as a, open(jax, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    assert got[:6] == b"CRAM" + bytes(WRITES[kind].get("version", (3, 0)))
    _records_equal(bam, port, fa)


@pytest.mark.parametrize("kind", list(WRITES))
def test_write_cram_records_match_bam(srdata, kind):
    """A BAM of two references, whose second slice of 5,000 records
    spans both: every record read back equals the BAM's. (The JAX
    package's writer starts a multi-reference slice's position deltas
    at its first record, where readers start at the slice header's 0,
    so its records there come back shifted; the port's starts at 0.)"""
    from delly_tpu_torch.io.bam import BamFile

    d, bam, fa, _truth, _one = srdata
    path = str(d / f"{kind.replace(' ', '_')}.two.cram")
    cram.write_cram(BamFile(bam), fa, path, **WRITES[kind])
    assert -2 in _ref_ids(path, fa)
    _records_equal(bam, path, fa)


def test_multiref_slice_positions(tmp_path):
    """The smallest multi-reference slice: two records on each of two
    contigs in one slice keep their positions through the port's
    write and read."""
    from bamsynth import encode_record, random_contig, write_bam, \
        write_fasta

    from delly_tpu_torch.io.bam import BamFile

    rng = random.Random(5)
    ra, rb = random_contig(rng, 2000), random_contig(rng, 2000)
    fa, bam = str(tmp_path / "r.fa"), str(tmp_path / "r.bam")
    write_fasta(fa, [("a", ra), ("b", rb)])
    recs = [(0, p, ra) for p in (100, 200)] + [(1, p, rb) for p in (50, 60)]
    write_bam(bam, [("a", ra), ("b", rb)], [encode_record(
        f"r{k}", 0, tid, p, 60, [("M", 50)], -1, -1, 0, ref[p:p + 50])
        for k, (tid, p, ref) in enumerate(recs)])
    path = str(tmp_path / "r.cram")
    cram.write_cram(BamFile(bam), fa, path, slice_size=4)
    assert _ref_ids(path, fa) == [-2]
    _records_equal(bam, path, fa)


# Runs each [stream threshold or None, argv] step through the port's
# cli.main in one process (the threshold set on io/bam.py for the step)
# and prints the exit codes and the jax/delly_tpu modules imported.
_DRIVER = """
import json, sys
from delly_tpu_torch.cli import main
from delly_tpu_torch.io import bam
default = bam.STREAM_THRESHOLD
rcs = []
for thr, argv in json.load(open(sys.argv[1])):
    bam.STREAM_THRESHOLD = default if thr is None else thr
    rcs.append(main(argv))
print("RCS=" + json.dumps(rcs))
print("LEAKED=" + json.dumps(sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "delly_tpu"))))
"""


def _port_steps(d, steps, mesh=None):
    path = str(d / f"steps.{len(os.listdir(d))}.json")
    with open(path, "w") as fh:
        json.dump(steps, fh)
    env = dict(os.environ, DELLY_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("DELLY_TPU_MESH", None)
    if mesh:
        env["DELLY_TPU_MESH"] = mesh
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", _DRIVER, path], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=400):
    try:
        so, se = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, se[-3000:]
    out = dict(ln.split("=", 1) for ln in so.splitlines() if "=" in ln)
    return json.loads(out["RCS"]), json.loads(out["LEAKED"])


@pytest.fixture(scope="module")
def cli_runs(srdata):
    """sr on the BAM and on a CRAM 3.1 of it (whole-file and streaming),
    lr on the long-read families' BAM and CRAM, by the port under
    DELLY_TPU_MESH=2, and the JAX package's sr and lr on the CRAMs."""
    from delly_tpu_torch.io.bam import BamFile

    d, bam, fa, _truth, _one = srdata
    sr_cram = str(d / "sr31.cram")
    cram.write_cram(BamFile(bam), fa, sr_cram, version=(3, 1))
    lbam, lfa, _ = make_lr_sv_dataset(str(d))
    lr_cram = str(d / "lr.cram")
    cram.write_cram(BamFile(lbam), lfa, lr_cram)
    o = lambda name: str(d / name)  # noqa: E731
    port = _port_steps(d, [
        [None, ["sr", "-g", fa, "-o", o("sr_bam.port.vcf"), bam]],
        [1 << 62, ["sr", "-g", fa, "-o", o("sr_whole.port.vcf"), sr_cram]],
        [0, ["sr", "-g", fa, "-o", o("sr_stream.port.vcf"), sr_cram]],
        [None, ["lr", "-g", lfa, "-o", o("lr_bam.port.vcf"), lbam]],
        [1 << 62, ["lr", "-g", lfa, "-o", o("lr_whole.port.vcf"), lr_cram]],
        [0, ["lr", "-g", lfa, "-o", o("lr_stream.port.vcf"), lr_cram]],
    ], mesh="2")
    try:
        jax = run_cli("delly_tpu", [
            ["sr", "-g", fa, "-o", o("sr.jax.vcf"), sr_cram],
            ["lr", "-g", lfa, "-o", o("lr.jax.vcf"), lr_cram]], d,
            timeout=400)
    finally:
        rcs, leaked = _finish(port)
    return d, jax, rcs, leaked, sr_cram, fa


def test_cram_runs_exit_zero(cli_runs):
    _d, jax, rcs, leaked, _c, _fa = cli_runs
    assert jax["rcs"] == [0, 0]
    assert rcs == [0] * 6
    # the port's process read CRAMs under a mesh of two and ends with
    # neither jax nor any delly_tpu module imported
    assert leaked == []


@pytest.mark.parametrize("word", ["sr", "lr"])
def test_cram_calls_match_bam_and_jax(cli_runs, word):
    d, *_rest = cli_runs
    want = output_lines(str(d / f"{word}.jax.vcf"))
    assert sum(not ln.startswith("#") for ln in want) >= 5

    def body(name):
        # the ##reference and header lines name the input file
        return [ln for ln in output_lines(str(d / name))
                if not ln.startswith("#")]

    assert body(f"{word}_whole.port.vcf") == body(f"{word}.jax.vcf")
    assert output_lines(str(d / f"{word}_whole.port.vcf")) == want
    assert output_lines(str(d / f"{word}_stream.port.vcf")) == want
    assert body(f"{word}_bam.port.vcf") == body(f"{word}.jax.vcf")


def test_streaming_cram_views_match_whole(cli_runs):
    """A streaming CRAM (region decode, no transcode) gives the records
    of the whole-file transcode, chromosome by chromosome."""
    from delly_tpu_torch.io.bam import BamFile

    _d, _jax, _rcs, _leaked, sr_cram, fa = cli_runs
    whole = BamFile(sr_cram, genome=fa, streaming=False)
    stream = BamFile(sr_cram, genome=fa, streaming=True)
    assert stream._cram is not None
    ci = whole.core_index()
    for tid in range(2):
        v = stream.chrom(tid)
        m = ci["tid"] == tid
        assert len(v) == int(m.sum()) > 0
        for k in ("pos", "flag", "mapq", "mtid", "mpos", "tlen", "lqseq"):
            np.testing.assert_array_equal(v[k], ci[k][m])
    stream.close()


def test_mapped_stats_on_streaming_cram(cli_runs, srdata):
    """A streaming CRAM has no .bai: the cnv mapped-read estimate takes
    the chunked scan and equals the BAM's, as in the JAX package."""
    from delly_tpu.io.bam import BamFile as JaxBam
    from delly_tpu.models.coral import _mapped_stats as jax_mapped_stats
    from delly_tpu_torch.io.bam import BamFile
    from delly_tpu_torch.models.coral import _mapped_stats

    _d, _jax, _rcs, _leaked, sr_cram, fa = cli_runs
    bam = srdata[1]
    stream = BamFile(sr_cram, genome=fa, streaming=True)
    assert stream.streaming and getattr(stream, "_bai", None) is None
    got = _mapped_stats(stream)
    stream.close()
    assert got == _mapped_stats(BamFile(bam))
    jstream = JaxBam(sr_cram, genome=fa, streaming=True)
    assert got == jax_mapped_stats(jstream)
    jstream.close()

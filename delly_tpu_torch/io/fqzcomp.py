"""fqzcomp quality codec (CRAM 3.1 block method 7).

Adaptive binary-search-free range coding over a context-modelled
quality stream: recent quality history, read position, delta-run and
selector feed a 16-bit context into per-context adaptive frequency
models, entropy-coded with a carry-propagating range coder.

Like io/rans_nx16.py and io/tok3.py this is a from-spec
reimplementation of the public CRAM 3.1 codecs document (no htscodecs
code consulted); the environment ships no htscodecs/samtools to
cross-check third-party byte streams, so validation is by round-trip
fuzzing over realistic quality corpora (tests/test_fqzcomp.py) — a
recorded limitation. The parameter-block layout (versions, gflags,
per-parameter context recipe) follows the specification structure.
"""

from __future__ import annotations

# ------------------------------------------------------- range coder
_TOP = 1 << 24


class RangeEncoder:
    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.out = bytearray()
        self.cache = 0
        self.carry_count = 0
        self.first = True

    def _shift_low(self):
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            if not self.first:
                self.out.append((self.cache + carry) & 0xFF)
            while self.carry_count:
                self.out.append((0xFF + carry) & 0xFF)
                self.carry_count -= 1
            self.cache = (self.low >> 24) & 0xFF
            self.first = False
        else:
            self.carry_count += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, cum: int, freq: int, tot: int):
        r = self.range // tot
        self.low += r * cum
        self.range = r * freq
        while self.range < _TOP:
            self.range <<= 8
            self._shift_low()

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(4):
            self.code = (self.code << 8) | self._byte()

    def _byte(self) -> int:
        b = self.buf[self.pos] if self.pos < len(self.buf) else 0
        self.pos += 1
        return b

    def get_freq(self, tot: int) -> int:
        self.r = self.range // tot
        return min(tot - 1, self.code // self.r)

    def decode(self, cum: int, freq: int, _tot: int):
        self.code -= cum * self.r
        self.range = self.r * freq
        while self.range < _TOP:
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFFFF
            self.range <<= 8


# --------------------------------------------------- adaptive model
_STEP = 16
_MAX_TOT = (1 << 16) - _STEP


class Model:
    """Adaptive frequency model with neighbour-swap reordering (the
    swap is part of the format: both sides must apply it)."""
    __slots__ = ("sym", "freq", "tot")

    def __init__(self, nsym: int):
        self.sym = list(range(nsym))
        self.freq = [1] * nsym
        self.tot = nsym

    def _rescale(self):
        t = 0
        for i in range(len(self.freq)):
            self.freq[i] -= self.freq[i] >> 1
            t += self.freq[i]
        self.tot = t

    def encode(self, rc: RangeEncoder, s: int):
        cum = 0
        i = 0
        sym = self.sym
        freq = self.freq
        while sym[i] != s:
            cum += freq[i]
            i += 1
        rc.encode(cum, freq[i], self.tot)
        freq[i] += _STEP
        self.tot += _STEP
        if i > 0 and freq[i] > freq[i - 1]:
            sym[i], sym[i - 1] = sym[i - 1], sym[i]
            freq[i], freq[i - 1] = freq[i - 1], freq[i]
        if self.tot > _MAX_TOT:
            self._rescale()

    def decode(self, rc: RangeDecoder) -> int:
        f = rc.get_freq(self.tot)
        cum = 0
        i = 0
        freq = self.freq
        while cum + freq[i] <= f:
            cum += freq[i]
            i += 1
        s = self.sym[i]
        rc.decode(cum, freq[i], self.tot)
        freq[i] += _STEP
        self.tot += _STEP
        if i > 0 and freq[i] > freq[i - 1]:
            self.sym[i], self.sym[i - 1] = self.sym[i - 1], self.sym[i]
            freq[i], freq[i - 1] = freq[i - 1], freq[i]
        if self.tot > _MAX_TOT:
            self._rescale()
        return s


# ----------------------------------------------------- fqzcomp proper
GFLAG_MULTI_PARAM = 1
GFLAG_HAVE_STAB = 2
GFLAG_DO_REV = 4

PFLAG_DO_DEDUP = 2
PFLAG_DO_LEN = 4
PFLAG_DO_SEL = 8
PFLAG_HAVE_QMAP = 16
PFLAG_HAVE_PTAB = 32
PFLAG_HAVE_DTAB = 64
PFLAG_HAVE_QTAB = 128


def _write_array(vals) -> bytes:
    """RLE table serialisation: (value, run-1) byte pairs, 255-capped
    runs, 0xFF-terminated by a run of count 0? — simple length-prefixed
    form: u8 count of (val, run) pairs (0 => 256 literal bytes
    follow)."""
    # run-length pairs
    pairs = []
    i = 0
    n = len(vals)
    while i < n:
        j = i
        while j < n and vals[j] == vals[i] and j - i < 255:
            j += 1
        pairs.append((vals[i], j - i))
        i = j
    if len(pairs) >= 128:
        return bytes([0]) + bytes(vals)
    out = bytearray([len(pairs)])
    for v, r in pairs:
        out += bytes([v, r])
    return bytes(out)


def _read_array(buf, pos, n=256):
    cnt = buf[pos]
    pos += 1
    if cnt == 0:
        return list(buf[pos:pos + n]), pos + n
    vals = []
    for _ in range(cnt):
        v, r = buf[pos], buf[pos + 1]
        pos += 2
        vals += [v] * r
    if len(vals) != n:
        raise ValueError("fqzcomp: bad table length")
    return vals, pos


class _Param:
    pass


def _read_params(buf, pos):
    vers = buf[pos]
    pos += 1
    if vers != 5:
        raise ValueError(f"fqzcomp: unsupported version {vers}")
    gflags = buf[pos]
    pos += 1
    nparam = 1
    if gflags & GFLAG_MULTI_PARAM:
        nparam = buf[pos]
        pos += 1
    stab = list(range(256))
    if gflags & GFLAG_HAVE_STAB:
        _max_sel = buf[pos]
        pos += 1
        stab, pos = _read_array(buf, pos)
    params = []
    for _ in range(nparam):
        p = _Param()
        p.context = buf[pos] | (buf[pos + 1] << 8)
        pos += 2
        p.pflags = buf[pos]
        pos += 1
        p.max_sym = buf[pos]
        pos += 1
        b = buf[pos]
        pos += 1
        p.qbits, p.qshift = b >> 4, b & 15
        b = buf[pos]
        pos += 1
        p.qloc, p.sloc = b >> 4, b & 15
        b = buf[pos]
        pos += 1
        p.ploc, p.dloc = b >> 4, b & 15
        p.qmap = list(range(256))
        if p.pflags & PFLAG_HAVE_QMAP:
            p.qmap, pos = _read_array(buf, pos)
        p.qtab = list(range(256))
        if p.pflags & PFLAG_HAVE_QTAB:
            p.qtab, pos = _read_array(buf, pos)
        p.ptab = [0] * 1024
        if p.pflags & PFLAG_HAVE_PTAB:
            p.ptab, pos = _read_array(buf, pos, 1024)
        p.dtab = [0] * 256
        if p.pflags & PFLAG_HAVE_DTAB:
            p.dtab, pos = _read_array(buf, pos)
        params.append(p)
    return gflags, nparam, stab, params, pos


def _write_params(gflags, nparam, stab, params) -> bytes:
    out = bytearray([5, gflags])
    if gflags & GFLAG_MULTI_PARAM:
        out.append(nparam)
    if gflags & GFLAG_HAVE_STAB:
        out.append(max(stab))
        out += _write_array(stab)
    for p in params:
        out += bytes([p.context & 0xFF, p.context >> 8, p.pflags,
                      p.max_sym, (p.qbits << 4) | p.qshift,
                      (p.qloc << 4) | p.sloc, (p.ploc << 4) | p.dloc])
        if p.pflags & PFLAG_HAVE_QMAP:
            out += _write_array(p.qmap)
        if p.pflags & PFLAG_HAVE_QTAB:
            out += _write_array(p.qtab)
        if p.pflags & PFLAG_HAVE_PTAB:
            out += _write_array(p.ptab)
        if p.pflags & PFLAG_HAVE_DTAB:
            out += _write_array(p.dtab)
    return bytes(out)


def _ctx(p, qhist, pos_in_read, delta, sel):
    ctx = p.context
    ctx += (qhist & ((1 << p.qbits) - 1)) << p.qloc
    ctx += p.ptab[min(pos_in_read, 1023)] << p.ploc
    ctx += p.dtab[min(delta, 255)] << p.dloc
    ctx += sel << p.sloc
    return ctx & 0xFFFF


def decode(buf: bytes, lengths: list | None = None,
           total_out: int | None = None) -> list:
    """Decode per-record quality strings. `lengths` gives each
    record's quality length; with DO_LEN streams (lengths embedded)
    pass `total_out` instead and records decode until the output total
    is reached."""
    gflags, nparam, stab, params, pos = _read_params(buf, 0)
    rc = RangeDecoder(buf, pos)
    qual_m = {}
    sel_m = Model(max(nparam, 1))
    dup_m = Model(2)
    len_m = [Model(256) for _ in range(4)]
    out = []
    prev = b""
    done = 0

    def more():
        if lengths is not None:
            return len(out) < len(lengths)
        return done < total_out

    # corrupt DO_LEN streams can emit endless zero-length or oversized
    # records; both must terminate with an error, not hang or allocate
    nrec_cap = ((len(lengths) if lengths is not None else total_out)
                + 1024)
    while more():
        if len(out) > nrec_cap:
            raise ValueError("fqzcomp: corrupt stream (record count "
                             "exceeds output size)")
        sel = sel_m.decode(rc) if nparam > 1 else 0
        x = stab[sel]
        p = params[x]
        if p.pflags & PFLAG_DO_LEN:
            ln = (len_m[0].decode(rc) | (len_m[1].decode(rc) << 8)
                  | (len_m[2].decode(rc) << 16)
                  | (len_m[3].decode(rc) << 24))
            if total_out is not None and done + ln > total_out:
                raise ValueError("fqzcomp: corrupt stream (record "
                                 "overruns output size)")
        else:
            ln = lengths[len(out)]
        if p.pflags & PFLAG_DO_DEDUP:
            if dup_m.decode(rc):
                out.append(prev[:ln])
                done += ln
                continue
        qhist = 0
        delta = 0
        q1 = 0
        rec = bytearray(ln)
        for i in range(ln):
            ctx = _ctx(p, qhist, i, delta, sel)
            m = qual_m.get(ctx)
            if m is None:
                m = qual_m[ctx] = Model(p.max_sym + 1)
            q = m.decode(rc)
            rec[i] = p.qmap[q] if p.pflags & PFLAG_HAVE_QMAP else q
            qhist = ((qhist << p.qshift) + p.qtab[q]) & 0xFFFFFFFF
            delta += q1 != q
            q1 = q
        prev = bytes(rec)
        out.append(prev)
        done += ln
    return out


def decode_block(buf: bytes, rsize: int) -> bytes:
    """CRAM block entry: DO_LEN stream -> the concatenated QS series
    bytes (rsize total). Native fast path (hostio.cpp fqz_decode) with
    this module as the behavioral contract and fallback."""
    try:
        from delly_tpu_torch import native
        out = native.fqz_decode_block(buf, rsize)
        if out is not None:
            return out
    except Exception:
        pass
    return b"".join(decode(buf, total_out=rsize))


def encode(quals: list, qshift: int = 5, qbits: int = 12,
           qloc: int = 4, pbits: int = 2, ploc: int = 0,
           dedup: bool = True, store_lens: bool = False) -> bytes:
    """Encode per-record quality byte strings (one parameter set,
    qmap over the observed symbols, coarse position context).
    store_lens embeds per-record lengths (the CRAM block form)."""
    syms = sorted({b for q in quals for b in q}) or [0]
    if len(syms) > 255:
        raise ValueError("fqzcomp: >255 distinct quality symbols")
    code_of = {s: i for i, s in enumerate(syms)}
    p = _Param()
    p.context = 0
    p.pflags = PFLAG_HAVE_QMAP | PFLAG_HAVE_PTAB | PFLAG_HAVE_QTAB
    if store_lens:
        p.pflags |= PFLAG_DO_LEN
    if dedup:
        p.pflags |= PFLAG_DO_DEDUP
    p.max_sym = len(syms) - 1
    p.qbits, p.qshift = qbits, qshift
    p.qloc, p.sloc = qloc, 0
    p.ploc, p.dloc = ploc, 0
    p.qmap = syms + [0] * (256 - len(syms))
    p.qtab = [min(i, (1 << qshift) - 1) for i in range(256)]
    p.ptab = [min(i >> 6, (1 << pbits) - 1) for i in range(1024)]
    p.dtab = [0] * 256
    gflags = 0
    head = _write_params(gflags, 1, list(range(256)), [p])

    rc = RangeEncoder()
    qual_m = {}
    dup_m = Model(2)
    len_m = [Model(256) for _ in range(4)]
    prev = None
    for q in quals:
        if p.pflags & PFLAG_DO_LEN:
            ln = len(q)
            len_m[0].encode(rc, ln & 0xFF)
            len_m[1].encode(rc, (ln >> 8) & 0xFF)
            len_m[2].encode(rc, (ln >> 16) & 0xFF)
            len_m[3].encode(rc, (ln >> 24) & 0xFF)
        if p.pflags & PFLAG_DO_DEDUP:
            if prev is not None and q == prev[:len(q)] \
                    and len(q) <= len(prev):
                dup_m.encode(rc, 1)
                continue
            dup_m.encode(rc, 0)
        qhist = 0
        delta = 0
        q1 = 0
        for i, b in enumerate(q):
            s = code_of[b]
            ctx = _ctx(p, qhist, i, delta, 0)
            m = qual_m.get(ctx)
            if m is None:
                m = qual_m[ctx] = Model(p.max_sym + 1)
            m.encode(rc, s)
            qhist = ((qhist << p.qshift) + p.qtab[s]) & 0xFFFFFFFF
            delta += q1 != s
            q1 = s
        prev = bytes(q)
    return head + rc.finish()

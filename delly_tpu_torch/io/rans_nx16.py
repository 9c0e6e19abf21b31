"""rANS Nx16 codec (CRAM 3.1 block method 5, htscodecs "rans4x16pr").

Spec-derived from the public CRAM 3.1 codecs specification
(CRAMcodecs: "rANS Nx16" — interleaved 32-bit-state rANS with 16-bit
renormalisation, 12-bit frequencies, plus the bit-pack / RLE / stripe
/ cat meta-transforms). Replaces htscodecs' role for the reference's
CRAM inputs (SURVEY.md component 29). No htscodecs code was consulted
— the byte formats follow the specification document; validation is
by exhaustive encode/decode round-trips across flag combinations
(tests/test_rans_nx16.py) and by full-pipeline identity of CRAM 3.1
inputs vs their BAM equivalents (tests/test_cram31.py).

Flag byte (first byte of every stream):
  0x01 ORDER1   order-1 (context) modelling, else order-0
  0x04 STRIPE   interleave N independent sub-streams
  0x08 NOSZ     uncompressed size not stored (caller knows it)
  0x10 CAT      payload is raw bytes (no entropy coding)
  0x20 RLE      run-length transform before entropy coding
  0x40 PACK     bit-pack transform before entropy coding
  0x80 X32      32-way rANS interleave (else 4-way)
"""

from __future__ import annotations

RANS_L = 1 << 15          # lower bound of the rANS state
TF_SHIFT = 12             # order-0 frequency precision (sum = 4096)
TF_SHIFT_O1 = 12          # order-1 default precision
TF_SHIFT_O1_FAST = 10     # order-1 reduced precision variant

F_ORDER1 = 0x01
F_STRIPE = 0x04
F_NOSZ = 0x08
F_CAT = 0x10
F_RLE = 0x20
F_PACK = 0x40
F_X32 = 0x80


# ---------------------------------------------------------------- uint7
def read_uint7(buf, pos):
    """Variable-size unsigned int: 7 bits per byte, most significant
    first, high bit = continuation."""
    v = 0
    while True:
        b = buf[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            return v, pos


def write_uint7(v: int) -> bytes:
    out = bytearray()
    out.append(v & 0x7F)
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


# ------------------------------------------------------------ alphabet
def _read_alphabet(buf, pos):
    """Symbol list: ascending values; a run of >=2 consecutive symbols
    stores the first two then a count byte of further symbols."""
    syms = []
    rle = 0
    last = -2
    while True:
        if rle > 0:
            rle -= 1
            sym = last + 1
        else:
            sym = buf[pos]
            pos += 1
            if syms and sym == 0:
                break
            if sym == last + 1:
                rle = buf[pos]
                pos += 1
        syms.append(sym)
        last = sym
    return syms, pos


def _write_alphabet(syms) -> bytes:
    out = bytearray()
    rle = 0
    last = -2
    for sym in syms:
        if rle > 0:
            rle -= 1
        else:
            out.append(sym)
            if sym == last + 1:
                # count the further consecutive symbols
                run = 0
                i = syms.index(sym)
                while (i + run + 1 < len(syms)
                       and syms[i + run + 1] == sym + run + 1):
                    run += 1
                out.append(run)
                rle = run
        last = sym
    out.append(0)
    return bytes(out)


def _normalise(freqs, shift):
    """Scale frequencies so they sum to exactly 1 << shift, keeping
    every nonzero frequency >= 1."""
    total = sum(freqs.values())
    target = 1 << shift
    out = {}
    acc = 0
    items = sorted(freqs.items())
    for sym, f in items:
        nf = max(1, (f * target) // total)
        out[sym] = nf
        acc += nf
    # fix the rounding drift on the most frequent symbol
    big = max(out, key=lambda s: out[s])
    out[big] += target - acc
    if out[big] < 1:
        # pathological skew: flatten
        out = {s: 1 for s, _ in items}
        out[items[0][0]] += target - len(items)
    return out


# ----------------------------------------------------- order-0 tables
def _read_freqs0(buf, pos, shift):
    syms, pos = _read_alphabet(buf, pos)
    freqs = {}
    for s in syms:
        f, pos = read_uint7(buf, pos)
        freqs[s] = f
    total = sum(freqs.values())
    if total != (1 << shift) and total > 0:
        # spec: frequencies are stored normalised; tolerate re-scale
        freqs = _normalise(freqs, shift)
    return freqs, pos


def _write_freqs0(freqs) -> bytes:
    out = bytearray(_write_alphabet(sorted(freqs)))
    for s in sorted(freqs):
        out += write_uint7(freqs[s])
    return bytes(out)


def _cum(freqs):
    cum = {}
    acc = 0
    for s in sorted(freqs):
        cum[s] = acc
        acc += freqs[s]
    return cum


def _lookup(freqs):
    """cumulative-frequency -> (sym, freq, cum) lookup table."""
    tbl = [None] * sum(freqs.values())
    acc = 0
    for s in sorted(freqs):
        f = freqs[s]
        for k in range(acc, acc + f):
            tbl[k] = (s, f, acc)
        acc += f
    return tbl


# ------------------------------------------------------- rANS order-0
def _native_entropy(buf, pos, out_sz, nway, order1):
    """Native entropy stage (hostio.cpp rans_nx16_decode), or None."""
    try:
        from delly_tpu_torch import native
        res = native.rans_nx16_entropy(bytes(buf[pos:]), out_sz,
                                       order1, nway)
    except Exception:
        return None
    if res is None:
        return None
    data, consumed = res
    return data, pos + consumed


def _rans_decode_0(buf, pos, out_sz, nway):
    nat = _native_entropy(buf, pos, out_sz, nway, False)
    if nat is not None:
        return nat
    shift = TF_SHIFT
    freqs, pos = _read_freqs0(buf, pos, shift)
    tbl = _lookup(freqs)
    mask = (1 << shift) - 1
    states = []
    for _ in range(nway):
        s = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        states.append(s)
    out = bytearray(out_sz)
    n_full = out_sz
    for i in range(n_full):
        j = i % nway
        x = states[j]
        sym, f, c = tbl[x & mask]
        out[i] = sym
        x = f * (x >> shift) + (x & mask) - c
        if x < RANS_L:
            x = (x << 16) | int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        states[j] = x
    return bytes(out), pos


def _rans_encode_0(data: bytes, nway) -> bytes:
    shift = TF_SHIFT
    freqs = {}
    for b in data:
        freqs[b] = freqs.get(b, 0) + 1
    if not freqs:
        freqs = {0: 1}
    freqs = _normalise(freqs, shift)
    cum = _cum(freqs)
    out_rev = bytearray()  # 16-bit renorm words, reversed at the end
    states = [RANS_L] * nway
    # encode symbols in reverse, round-robin in reverse
    for i in range(len(data) - 1, -1, -1):
        j = i % nway
        s = data[i]
        f = freqs[s]
        x = states[j]
        x_max = ((RANS_L >> shift) << 16) * f
        while x >= x_max:
            out_rev += (x & 0xFFFF).to_bytes(2, "little")
            x >>= 16
        states[j] = ((x // f) << shift) + (x % f) + cum[s]
    head = bytearray(_write_freqs0(freqs))
    for j in range(nway):
        head += states[j].to_bytes(4, "little")
    # the byte stream is emitted reversed in 16-bit units
    tail = bytearray()
    for k in range(len(out_rev) - 2, -2, -2):
        tail += out_rev[k:k + 2]
    return bytes(head + tail)


# ------------------------------------------------------- rANS order-1
def _read_freqs1(buf, pos, nway):
    """Order-1 tables: optionally rans-order-0 compressed; a shared
    context alphabet then one order-0-style table per context."""
    comp = buf[pos]
    pos += 1
    shift = TF_SHIFT_O1 if (comp >> 4) != 1 else TF_SHIFT_O1_FAST
    if comp & 1:
        clen, pos = read_uint7(buf, pos)
        ulen, pos = read_uint7(buf, pos)
        sub, _ = _rans_decode_0(buf, pos, ulen, 4)
        pos += clen
        tbl_buf, tpos = sub, 0
    else:
        tbl_buf, tpos = buf, pos
    syms, tpos = _read_alphabet(tbl_buf, tpos)
    tables = {}
    for ctx in syms:
        freqs = {}
        # per-context frequencies over the shared alphabet; zero
        # frequencies are run-length encoded: a 0 is followed by a
        # count of further zeros
        zrun = 0
        for s in syms:
            if zrun > 0:
                zrun -= 1
                continue
            f, tpos = read_uint7(tbl_buf, tpos)
            if f == 0:
                zrun = tbl_buf[tpos]
                tpos += 1
                continue
            freqs[s] = f
        if freqs:
            total = sum(freqs.values())
            if total != (1 << shift):
                freqs = _normalise(freqs, shift)
        tables[ctx] = freqs
    if not (comp & 1):
        pos = tpos
    return tables, shift, pos


def _write_freqs1(tables, shift) -> bytes:
    syms = sorted(tables)
    body = bytearray(_write_alphabet(syms))
    for ctx in syms:
        freqs = tables[ctx]
        zrun = 0
        pend = bytearray()
        for s in syms:
            f = freqs.get(s, 0)
            if f == 0:
                if zrun == 0:
                    pend += write_uint7(0)
                    zpos = len(pend)
                    pend.append(0)
                else:
                    pend[zpos] += 1
                zrun += 1
                if pend[zpos] == 255:
                    zrun = 0
            else:
                zrun = 0
                pend += write_uint7(f)
        body += pend
    head = bytearray()
    head.append(0 if shift == TF_SHIFT_O1 else (1 << 4))
    return bytes(head + body)


def _rans_decode_1(buf, pos, out_sz, nway):
    nat = _native_entropy(buf, pos, out_sz, nway, True)
    if nat is not None:
        return nat
    tables, shift, pos = _read_freqs1(buf, pos, nway)
    lut = {ctx: _lookup(f) if f else None
           for ctx, f in tables.items()}
    mask = (1 << shift) - 1
    states = []
    for _ in range(nway):
        s = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        states.append(s)
    # each interleaved way decodes an independent CONTIGUOUS fraction
    # of the output (order-1 context = previous byte within the way's
    # slice); the last way absorbs the remainder
    frac = out_sz // nway
    out = bytearray(out_sz)
    starts = [j * frac for j in range(nway)]
    ends = [(j + 1) * frac for j in range(nway)]
    ends[nway - 1] = out_sz
    ctxs = [0] * nway
    idx = list(starts)
    remaining = out_sz
    while remaining > 0:
        for j in range(nway):
            if idx[j] >= ends[j]:
                continue
            x = states[j]
            tbl = lut[ctxs[j]]
            sym, f, c = tbl[x & mask]
            out[idx[j]] = sym
            idx[j] += 1
            remaining -= 1
            x = f * (x >> shift) + (x & mask) - c
            if x < RANS_L:
                x = (x << 16) | int.from_bytes(buf[pos:pos + 2],
                                               "little")
                pos += 2
            states[j] = x
            ctxs[j] = sym
    return bytes(out), pos


def _rans_encode_1(data: bytes, nway) -> bytes:
    out_sz = len(data)
    frac = out_sz // nway
    starts = [j * frac for j in range(nway)]
    ends = [(j + 1) * frac for j in range(nway)]
    ends[nway - 1] = out_sz
    # gather order-1 stats (context 0 at each slice start)
    shift = TF_SHIFT_O1
    stats: dict = {}
    for j in range(nway):
        ctx = 0
        for i in range(starts[j], ends[j]):
            stats.setdefault(ctx, {})
            s = data[i]
            stats[ctx][s] = stats[ctx].get(s, 0) + 1
            ctx = s
    if not stats:
        stats = {0: {0: 1}}
    tables = {ctx: _normalise(f, shift) for ctx, f in stats.items()}
    # every context value must appear in the shared alphabet
    allsyms = set(tables)
    for f in tables.values():
        allsyms |= set(f)
    for s in allsyms:
        tables.setdefault(s, {s: 1 << shift})
    cums = {ctx: _cum(f) for ctx, f in tables.items()}
    mask_shift = shift

    # interleaved encode: process positions in REVERSE of the decode
    # round-robin order
    order = []
    idx = list(starts)
    remaining = out_sz
    while remaining > 0:
        for j in range(nway):
            if idx[j] >= ends[j]:
                continue
            order.append((j, idx[j]))
            idx[j] += 1
            remaining -= 1
    states = [RANS_L] * nway
    out_rev = bytearray()
    for j, i in reversed(order):
        s = data[i]
        ctx = data[i - 1] if i > starts[j] else 0
        f = tables[ctx][s]
        c = cums[ctx][s]
        x = states[j]
        x_max = ((RANS_L >> mask_shift) << 16) * f
        while x >= x_max:
            out_rev += (x & 0xFFFF).to_bytes(2, "little")
            x >>= 16
        states[j] = ((x // f) << mask_shift) + (x % f) + c
    head = bytearray(_write_freqs1(tables, shift))
    for j in range(nway):
        head += states[j].to_bytes(4, "little")
    tail = bytearray()
    for k in range(len(out_rev) - 2, -2, -2):
        tail += out_rev[k:k + 2]
    return bytes(head + tail)


# ------------------------------------------------------ meta transforms
def _unpack_bits(packed: bytes, nsym: int, syms, out_sz: int) -> bytes:
    import numpy as np

    if nsym <= 1:
        return bytes([syms[0] if syms else 0]) * out_sz
    pk = np.frombuffer(packed, dtype=np.uint8)
    lut = np.asarray(syms + [0] * (16 - len(syms)), dtype=np.uint8)
    if nsym <= 2:
        idx = ((pk[:, None] >> np.arange(8, dtype=np.uint8)) & 1)
    elif nsym <= 4:
        idx = ((pk[:, None] >> (np.arange(4, dtype=np.uint8) * 2)) & 3)
    else:
        idx = ((pk[:, None] >> (np.arange(2, dtype=np.uint8) * 4)) & 15)
    return lut[idx.reshape(-1)[:out_sz]].tobytes()


def _pack_bits(data: bytes, syms) -> bytes:
    nsym = len(syms)
    code = {s: i for i, s in enumerate(syms)}
    if nsym <= 1:
        return b""
    if nsym <= 2:
        out = bytearray((len(data) + 7) >> 3)
        for i, b in enumerate(data):
            out[i >> 3] |= code[b] << (i & 7)
    elif nsym <= 4:
        out = bytearray((len(data) + 3) >> 2)
        for i, b in enumerate(data):
            out[i >> 2] |= code[b] << ((i & 3) << 1)
    else:
        out = bytearray((len(data) + 1) >> 1)
        for i, b in enumerate(data):
            out[i >> 1] |= code[b] << ((i & 1) << 2)
    return bytes(out)


def _rle_decode(run_meta: bytes, lit: bytes, out_sz: int) -> bytes:
    """Expand the RLE transform: `run_meta` holds the runnable-symbol
    set and the per-occurrence run lengths; `lit` the literals."""
    mpos = 0
    nrun = run_meta[mpos]
    mpos += 1
    if nrun == 0:
        nrun = 256
    runnable = set(run_meta[mpos:mpos + nrun])
    mpos += nrun
    out = bytearray()
    lpos = 0
    while len(out) < out_sz:
        b = lit[lpos]
        lpos += 1
        out.append(b)
        if b in runnable:
            run, mpos = read_uint7(run_meta, mpos)
            out += bytes([b]) * run
    return bytes(out[:out_sz])


def _rle_encode(data: bytes):
    """Choose runnable symbols (any symbol with runs), emit literals +
    run meta."""
    # symbols that ever repeat consecutively become runnable
    runnable = set()
    i = 0
    n = len(data)
    while i + 1 < n:
        if data[i] == data[i + 1]:
            runnable.add(data[i])
            j = i
            while j < n and data[j] == data[i]:
                j += 1
            i = j
        else:
            i += 1
    if not runnable:
        runnable = {data[0]} if data else {0}
    meta = bytearray()
    meta.append(len(runnable) & 0xFF)
    meta += bytes(sorted(runnable))
    lit = bytearray()
    i = 0
    while i < n:
        b = data[i]
        lit.append(b)
        if b in runnable:
            j = i
            while j < n and data[j] == b:
                j += 1
            meta += write_uint7(j - i - 1)
            i = j
        else:
            i += 1
    return bytes(meta), bytes(lit)


# ------------------------------------------------------------- public
def decode(buf: bytes, out_sz: int | None = None, pos: int = 0):
    """Decode one rANS Nx16 stream; returns (bytes, end_pos)."""
    flags = buf[pos]
    pos += 1
    if not (flags & F_NOSZ):
        out_sz, pos = read_uint7(buf, pos)
    if out_sz is None:
        raise ValueError("rANS Nx16: NOSZ stream needs an explicit size")
    if out_sz > max(1 << 30, len(buf) * 4096):
        # corrupt size fields must fail, not allocate unbounded output
        raise ValueError("rANS Nx16: implausible uncompressed size")
    nway = 32 if flags & F_X32 else 4

    if flags & F_STRIPE:
        n = buf[pos]
        pos += 1
        lens = []
        for _ in range(n):
            ln, pos = read_uint7(buf, pos)
            lens.append(ln)
        subs = []
        for j in range(n):
            sub_sz = out_sz // n + (1 if j < out_sz % n else 0)
            sub, _ = decode(buf, sub_sz, pos)
            subs.append(sub)
            pos += lens[j]
        out = bytearray(out_sz)
        for j in range(n):
            out[j::n] = subs[j]
        return bytes(out), pos

    pack_syms = None
    packed_sz = out_sz
    if flags & F_PACK:
        nsym = buf[pos]
        pos += 1
        pack_syms = list(buf[pos:pos + nsym])
        pos += nsym
        packed_sz, pos = read_uint7(buf, pos)

    rle_meta = None
    lit_sz = packed_sz
    if flags & F_RLE:
        rm_len, pos = read_uint7(buf, pos)
        lit_sz, pos = read_uint7(buf, pos)
        comp_flag = rm_len & 1
        rm_len >>= 1
        if comp_flag:
            # run meta stored raw
            rle_meta = bytes(buf[pos:pos + rm_len])
            pos += rm_len
        else:
            u_len, pos2 = read_uint7(buf, pos)
            rle_meta, _ = _rans_decode_0(buf, pos2, u_len, 4)
            pos += rm_len

    if flags & F_CAT:
        payload = bytes(buf[pos:pos + lit_sz])
        pos += lit_sz
    elif flags & F_ORDER1:
        payload, pos = _rans_decode_1(buf, pos, lit_sz, nway)
    else:
        payload, pos = _rans_decode_0(buf, pos, lit_sz, nway)

    if flags & F_RLE:
        payload = _rle_decode(rle_meta, payload, packed_sz)
    if flags & F_PACK:
        payload = _unpack_bits(payload, len(pack_syms), pack_syms,
                               out_sz)
    return payload, pos


def encode(data: bytes, flags: int = 0) -> bytes:
    """Encode one rANS Nx16 stream with the requested transforms."""
    out = bytearray()
    out.append(flags)
    if not (flags & F_NOSZ):
        out += write_uint7(len(data))
    nway = 32 if flags & F_X32 else 4

    if flags & F_STRIPE:
        n = 4
        out.append(n)
        subs = []
        sub_flags = flags & ~(F_STRIPE | F_NOSZ)
        for j in range(n):
            subs.append(encode(bytes(data[j::n]), sub_flags))
        for s in subs:
            out += write_uint7(len(s))
        for s in subs:
            out += s
        return bytes(out)

    payload = data
    if flags & F_PACK:
        syms = sorted(set(payload)) or [0]
        if len(syms) > 16:
            raise ValueError("PACK needs <= 16 distinct symbols")
        out.append(len(syms))
        out += bytes(syms)
        payload = _pack_bits(payload, syms)
        out += write_uint7(len(payload))

    if flags & F_RLE:
        meta, payload = _rle_encode(payload)
        out += write_uint7((len(meta) << 1) | 1)  # raw meta
        out += write_uint7(len(payload))
        out += meta

    if flags & F_CAT:
        out += payload
    elif flags & F_ORDER1:
        out += _rans_encode_1(payload, nway)
    else:
        out += _rans_encode_0(payload, nway)
    return bytes(out)

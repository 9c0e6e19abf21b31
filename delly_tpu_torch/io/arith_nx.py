"""Adaptive arithmetic codec (CRAM 3.1 block method 6).

Order-0 / order-1 adaptive byte models over the carry-propagating
range coder (io/fqzcomp.py), with the same meta-transform set as the
rANS Nx16 plane (PACK / RLE / CAT / STRIPE / NOSZ — io/rans_nx16.py
helpers). Spec-derived like its siblings; validated by round-trip
fuzzing (tests/test_arith_nx.py) and by CRAM 3.1 end-to-end record
equality — the environment ships no htscodecs to cross-check
third-party byte streams, a recorded limitation shared by the whole
3.1 plane.
"""

from __future__ import annotations

from delly_tpu_torch.io.fqzcomp import Model, RangeDecoder, RangeEncoder
from delly_tpu_torch.io.rans_nx16 import (
    F_CAT, F_NOSZ, F_ORDER1, F_PACK, F_RLE, F_STRIPE, _pack_bits,
    _rle_decode, _rle_encode, _unpack_bits, read_uint7, write_uint7,
)


def _arith_decode_bytes(buf, pos, out_sz, order1: bool):
    # native fast path (hostio.cpp arith_decode_bytes); the consumed
    # end position is only meaningful for the terminal entropy stage,
    # where no caller reads it (STRIPE advances by stored lengths)
    try:
        from delly_tpu_torch import native
        out = native.arith_decode_bytes(bytes(buf[pos:]), out_sz,
                                        order1)
        if out is not None:
            return out, len(buf)
    except Exception:
        pass
    rc = RangeDecoder(buf, pos)
    out = bytearray(out_sz)
    if order1:
        models = {}
        ctx = 0
        for i in range(out_sz):
            m = models.get(ctx)
            if m is None:
                m = models[ctx] = Model(256)
            b = m.decode(rc)
            out[i] = b
            ctx = b
    else:
        m = Model(256)
        for i in range(out_sz):
            out[i] = m.decode(rc)
    return bytes(out), rc.pos


def _arith_encode_bytes(data: bytes, order1: bool) -> bytes:
    rc = RangeEncoder()
    if order1:
        models = {}
        ctx = 0
        for b in data:
            m = models.get(ctx)
            if m is None:
                m = models[ctx] = Model(256)
            m.encode(rc, b)
            ctx = b
    else:
        m = Model(256)
        for b in data:
            m.encode(rc, b)
    return rc.finish()


def decode(buf: bytes, out_sz: int | None = None, pos: int = 0):
    """Decode one arith stream; returns (bytes, end_pos)."""
    flags = buf[pos]
    pos += 1
    if not (flags & F_NOSZ):
        out_sz, pos = read_uint7(buf, pos)
    if out_sz is None:
        raise ValueError("arith: NOSZ stream needs an explicit size")
    if out_sz > max(1 << 30, len(buf) * 4096):
        # corrupt size fields must fail, not allocate unbounded output
        raise ValueError("arith: implausible uncompressed size")

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
        rm_len >>= 1  # low bit: raw meta (always set by this encoder)
        rle_meta = bytes(buf[pos:pos + rm_len])
        pos += rm_len

    if flags & F_CAT:
        payload = bytes(buf[pos:pos + lit_sz])
        pos += lit_sz
    else:
        payload, pos = _arith_decode_bytes(buf, pos, lit_sz,
                                           bool(flags & F_ORDER1))

    if flags & F_RLE:
        payload = _rle_decode(rle_meta, payload, packed_sz)
    if flags & F_PACK:
        payload = _unpack_bits(payload, len(pack_syms), pack_syms,
                               out_sz)
    return payload, pos


def encode(data: bytes, flags: int = 0) -> bytes:
    """Encode one arith stream with the requested transforms."""
    out = bytearray([flags])
    if not (flags & F_NOSZ):
        out += write_uint7(len(data))

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
        out += write_uint7((len(meta) << 1) | 1)
        out += write_uint7(len(payload))
        out += meta

    if flags & F_CAT:
        out += payload
    else:
        out += _arith_encode_bytes(payload, bool(flags & F_ORDER1))
    return bytes(out)

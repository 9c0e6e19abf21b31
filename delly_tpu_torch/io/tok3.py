"""Name tokeniser codec (CRAM 3.1 block method 8, htscodecs "tok3").

Read names are tokenised (alpha runs, digit runs with and without
leading zeros, single chars) and each token slot becomes a column;
every column's data is delta-coded against the previous name's token
in the same slot (MATCH / DELTA / literal) and the per-column streams
are entropy-coded with rANS Nx16. Token model and stream layout follow
the public CRAM 3.1 codecs specification; like io/rans_nx16.py this is
a from-spec reimplementation (no htscodecs code consulted), validated
by round-trip fuzzing over realistic name corpora
(tests/test_tok3.py) and by CRAM 3.1 end-to-end pipeline identity —
the environment ships no htscodecs/samtools to cross-check third-party
byte streams, which is recorded as a known validation limit.

Token types (4-bit ids, spec order):
  0 TYPE  1 ALPHA  2 CHAR  3 DIGITS0  4 DZLEN  5 DUP  6 DIFF
  7 DIGITS  8 DELTA  9 DELTA0  10 MATCH  11 NOP  12 END
"""

from __future__ import annotations

import struct

from delly_tpu_torch.io import rans_nx16

(T_TYPE, T_ALPHA, T_CHAR, T_DIGITS0, T_DZLEN, T_DUP, T_DIFF, T_DIGITS,
 T_DELTA, T_DELTA0, T_MATCH, T_NOP, T_END) = range(13)

MAX_TOKENS = 128


class _Streams:
    def __init__(self):
        self.data = {}  # (pos, type) -> bytearray

    def put(self, pos, typ, payload: bytes = b""):
        self.data.setdefault((pos, typ), bytearray()).extend(payload)

    def put_b(self, pos, typ, b: int):
        self.data.setdefault((pos, typ), bytearray()).append(b)

    def put_u32(self, pos, typ, v: int):
        self.data.setdefault((pos, typ), bytearray()).extend(
            struct.pack("<I", v))


def _tokenise(name: bytes):
    """Split into (kind, text) tokens: kind in ALPHA/CHAR/DIGITS/
    DIGITS0 (leading zero)."""
    toks = []
    i = 0
    n = len(name)
    while i < n:
        c = name[i]
        if 0x30 <= c <= 0x39:
            j = i
            while j < n and 0x30 <= name[j] <= 0x39:
                j += 1
            # cap runs so values fit uint32
            while j - i > 9:
                toks.append((T_DIGITS0 if name[i] == 0x30
                             else T_DIGITS, name[i:i + 9]))
                i += 9
            if j > i:
                toks.append((T_DIGITS0 if (name[i] == 0x30 and j - i > 1)
                             else T_DIGITS, name[i:j]))
            i = j
        elif (0x41 <= c <= 0x5A) or (0x61 <= c <= 0x7A):
            j = i
            while j < n and ((0x41 <= name[j] <= 0x5A)
                             or (0x61 <= name[j] <= 0x7A)):
                j += 1
            toks.append((T_ALPHA, name[i:j]))
            i = j
        else:
            toks.append((T_CHAR, name[i:i + 1]))
            i += 1
    return toks


def encode(names: list, flags_literal: int = 0,
           flags_numeric: int = 0) -> bytes:
    """Encode a list of name byte strings (no terminators)."""
    names = [bytes(n) for n in names]
    st = _Streams()
    prev_toks = []  # token list of every earlier name
    for ni, name in enumerate(names):
        if ni > 0 and name == names[ni - 1]:
            st.put_b(0, T_TYPE, T_DUP)
            st.put_u32(0, T_DUP, 1)
            prev_toks.append(prev_toks[-1])
            continue
        st.put_b(0, T_TYPE, T_DIFF)
        st.put_u32(0, T_DIFF, 1 if ni > 0 else 0)
        toks = _tokenise(name)
        if len(toks) > MAX_TOKENS - 2:
            # lossless overflow: the tail collapses into one literal
            # token (read names never contain NUL, the ALPHA stream's
            # terminator)
            head = toks[:MAX_TOKENS - 3]
            tail = b"".join(t[1] for t in toks[MAX_TOKENS - 3:])
            toks = head + [(T_ALPHA, tail)]
        ref = prev_toks[-1] if prev_toks else []
        for t, (kind, text) in enumerate(toks):
            p = t + 1
            rkind, rtext = ref[t] if t < len(ref) else (None, b"")
            if (kind, text) == (rkind, rtext):
                st.put_b(p, T_TYPE, T_MATCH)
            elif kind == T_DIGITS and rkind == T_DIGITS:
                v = int(text)
                rv = int(rtext)
                if 0 <= v - rv < 256:
                    st.put_b(p, T_TYPE, T_DELTA)
                    st.put_b(p, T_DELTA, v - rv)
                else:
                    st.put_b(p, T_TYPE, T_DIGITS)
                    st.put_u32(p, T_DIGITS, v)
            elif (kind == T_DIGITS0 and rkind == T_DIGITS0
                  and len(text) == len(rtext)
                  and 0 <= int(text) - int(rtext) < 256):
                st.put_b(p, T_TYPE, T_DELTA0)
                st.put_b(p, T_DELTA0, int(text) - int(rtext))
            elif kind == T_DIGITS:
                st.put_b(p, T_TYPE, T_DIGITS)
                st.put_u32(p, T_DIGITS, int(text))
            elif kind == T_DIGITS0:
                st.put_b(p, T_TYPE, T_DIGITS0)
                st.put_u32(p, T_DIGITS0, int(text))
                st.put_b(p, T_DZLEN, len(text))
            elif kind == T_ALPHA:
                st.put_b(p, T_TYPE, T_ALPHA)
                st.put(p, T_ALPHA, text + b"\x00")
            else:
                st.put_b(p, T_TYPE, T_CHAR)
                st.put(p, T_CHAR, text)
        st.put_b(len(toks) + 1, T_TYPE, T_END)
        prev_toks.append(toks)

    ulen = sum(len(n) + 1 for n in names)
    out = bytearray()
    out += struct.pack("<I", ulen)
    out += struct.pack("<I", len(names))
    out.append(0)  # 0 = rANS Nx16 entropy coding (1 would be arith)
    last_pos = -1
    for (pos, typ) in sorted(st.data):
        blob = bytes(st.data[(pos, typ)])
        fl = flags_numeric if typ in (T_DIGITS, T_DIGITS0, T_DIFF,
                                      T_DUP) else flags_literal
        try:
            enc = rans_nx16.encode(blob, fl)
        except ValueError:
            enc = rans_nx16.encode(blob, 0)
        ttype = typ | (0x80 if pos == last_pos else 0)
        out.append(ttype)
        if pos != last_pos:
            out += rans_nx16.write_uint7(pos)
            last_pos = pos
        out += rans_nx16.write_uint7(len(enc))
        out += enc
    return bytes(out)


def decode(buf: bytes, rsize: int | None = None) -> bytes:
    """Decode to newline-free names joined by NUL (CRAM RN convention:
    one name per record, NUL-terminated)."""
    ulen, n_names = struct.unpack_from("<II", buf, 0)
    use_arith = buf[8]
    if use_arith:
        raise ValueError("tok3: arithmetic-coded name streams not "
                         "supported (rANS mode is)")
    pos = 9
    streams = {}
    last_pos = -1
    while pos < len(buf):
        ttype = buf[pos]
        pos += 1
        typ = ttype & 0x3F
        if ttype & 0x80:
            spos = last_pos
        else:
            spos, pos = rans_nx16.read_uint7(buf, pos)
            last_pos = spos
        clen, pos = rans_nx16.read_uint7(buf, pos)
        blob, _ = rans_nx16.decode(buf[pos:pos + clen])
        pos += clen
        streams[(spos, typ)] = [blob, 0]

    def take(p, typ, k):
        s = streams[(p, typ)]
        out = s[0][s[1]:s[1] + k]
        s[1] += k
        return out

    def take_str(p, typ):
        s = streams[(p, typ)]
        end = s[0].index(0, s[1])
        out = s[0][s[1]:end]
        s[1] = end + 1
        return out

    names = []
    toks_hist = []
    for ni in range(n_names):
        t0 = take(0, T_TYPE, 1)[0]
        if t0 == T_DUP:
            struct.unpack("<I", take(0, T_DUP, 4))
            names.append(names[-1])
            toks_hist.append(toks_hist[-1])
            continue
        if t0 != T_DIFF:
            raise ValueError(f"tok3: bad leading token {t0}")
        struct.unpack("<I", take(0, T_DIFF, 4))
        ref = toks_hist[-1] if toks_hist else []
        toks = []
        p = 1
        while True:
            tt = take(p, T_TYPE, 1)[0]
            if tt == T_END:
                break
            rkind, rtext = ref[p - 1] if p - 1 < len(ref) else (None,
                                                               b"")
            if tt == T_MATCH:
                toks.append((rkind, rtext))
            elif tt == T_DELTA:
                d = take(p, T_DELTA, 1)[0]
                toks.append((T_DIGITS, str(int(rtext) + d).encode()))
            elif tt == T_DELTA0:
                d = take(p, T_DELTA0, 1)[0]
                v = str(int(rtext) + d).encode()
                toks.append((T_DIGITS0,
                             v.rjust(len(rtext), b"0")))
            elif tt == T_DIGITS:
                (v,) = struct.unpack("<I", take(p, T_DIGITS, 4))
                toks.append((T_DIGITS, str(v).encode()))
            elif tt == T_DIGITS0:
                (v,) = struct.unpack("<I", take(p, T_DIGITS0, 4))
                ln = take(p, T_DZLEN, 1)[0]
                toks.append((T_DIGITS0,
                             str(v).encode().rjust(ln, b"0")))
            elif tt == T_ALPHA:
                toks.append((T_ALPHA, take_str(p, T_ALPHA)))
            elif tt == T_CHAR:
                toks.append((T_CHAR, take(p, T_CHAR, 1)))
            else:
                raise ValueError(f"tok3: bad token type {tt}")
            p += 1
        names.append(b"".join(t[1] for t in toks))
        toks_hist.append(toks)
    out = b"\x00".join(names) + b"\x00"
    if rsize is not None and len(out) != rsize:
        # RN streams may be newline-separated in some profiles; keep
        # NUL (the reader splits on NUL)
        pass
    return out

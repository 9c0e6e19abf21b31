"""CRAM 3.0 reader: decodes CRAM containers and transcodes to an
in-memory uncompressed BAM stream, so every downstream consumer (the
SoA core index, the native cigar/coverage passes, record parsing) runs
unchanged on CRAM input.

Role of HTSlib's cram_* decoders in the reference (SURVEY.md section 2
component 29: "BAM/CRAM indexed iteration"). Supported block codecs:
raw, gzip, bzip2, lzma, rANS 4x8 (order 0/1). Supported field
encodings: NULL, EXTERNAL, HUFFMAN (canonical, incl. 0-bit), BETA,
BYTE_ARRAY_LEN, BYTE_ARRAY_STOP. CRAM 3.1 codecs are rejected with a
clear error.

A matching writer (`write_cram`) emits spec-conformant CRAM 3.0 with
reference-based features; it exists for round-trip validation and
interop tests.
"""

from __future__ import annotations

import bz2
import gzip
import os
import lzma
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------


def read_itf8(buf: bytes, pos: int):
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | buf[pos + 1], pos + 2
    if b0 < 0xE0:
        return (((b0 & 0x1F) << 16) | (buf[pos + 1] << 8)
                | buf[pos + 2]), pos + 3
    if b0 < 0xF0:
        return (((b0 & 0x0F) << 24) | (buf[pos + 1] << 16)
                | (buf[pos + 2] << 8) | buf[pos + 3]), pos + 4
    v = (((b0 & 0x0F) << 28) | (buf[pos + 1] << 20) | (buf[pos + 2] << 12)
         | (buf[pos + 3] << 4) | (buf[pos + 4] & 0x0F))
    return v, pos + 5


def read_itf8_signed(buf: bytes, pos: int):
    v, pos = read_itf8(buf, pos)
    if v >= 1 << 31:
        v -= 1 << 32
    return v, pos


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def read_ltf8(buf: bytes, pos: int):
    b0 = buf[pos]
    n = 0
    while n < 8 and (b0 << n) & 0x80:
        n += 1
    if n == 0:
        return b0, pos + 1
    v = b0 & (0xFF >> (n + 1)) if n < 8 else 0
    for k in range(n):
        v = (v << 8) | buf[pos + 1 + k]
    return v, pos + 1 + n


def write_ltf8(v: int) -> bytes:
    if v < (1 << 7):
        return bytes([v])
    if v < (1 << 14):
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < (1 << 21):
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < (1 << 28):
        return bytes([0xE0 | (v >> 24)]) + (v & 0xFFFFFF).to_bytes(3, "big")
    if v < (1 << 35):
        return bytes([0xF0 | (v >> 32)]) + (v & 0xFFFFFFFF).to_bytes(4, "big")
    if v < (1 << 42):
        return (bytes([0xF8 | (v >> 40)])
                + (v & ((1 << 40) - 1)).to_bytes(5, "big"))
    if v < (1 << 49):
        return (bytes([0xFC | (v >> 48)])
                + (v & ((1 << 48) - 1)).to_bytes(6, "big"))
    if v < (1 << 56):
        return bytes([0xFE]) + v.to_bytes(7, "big")
    return bytes([0xFF]) + v.to_bytes(8, "big")


# ---------------------------------------------------------------------
# rANS 4x8 codec (htscodecs rans_static, CRAM 3.0 block method 4)
# ---------------------------------------------------------------------

RANS_L = 1 << 23
TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT


def _read_freq_table0(buf, pos):
    """Order-0 table, htscodecs layout: sym [rle] freq ... 0-terminator."""
    freqs = {}
    rle = 0
    sym = buf[pos]
    pos += 1
    last_sym = sym
    while True:
        f, pos = read_itf8(buf, pos)
        freqs[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = buf[pos]
            pos += 1
            if nxt == last_sym + 1:
                rle = buf[pos]
                pos += 1
            sym = nxt
            if sym == 0:
                break
        last_sym = sym
    return freqs, pos


def _rans_decode_order0(data, pos, out_sz):
    freqs, pos = _read_freq_table0(data, pos)
    cum = {}
    c = 0
    lookup = np.zeros(TOTFREQ, dtype=np.uint8)
    fstart = np.zeros(256, dtype=np.uint32)
    ffreq = np.zeros(256, dtype=np.uint32)
    for s in sorted(freqs):
        f = freqs[s]
        cum[s] = c
        lookup[c:c + f] = s
        fstart[s] = c
        ffreq[s] = f
        c += f
    states = list(struct.unpack_from("<4I", data, pos))
    pos += 16
    out = bytearray(out_sz)
    dlen = len(data)
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        m = x & (TOTFREQ - 1)
        s = lookup[m]
        out[i] = s
        x = int(ffreq[s]) * (x >> TF_SHIFT) + m - int(fstart[s])
        while x < RANS_L and pos < dlen:
            x = (x << 8) | data[pos]
            pos += 1
        states[j] = x
    return bytes(out), pos


def _rans_decode_order1(data, pos, out_sz):
    # outer table: context symbols with RLE, each row an order-0 table
    F = {}
    rle_i = 0
    i_sym = data[pos]
    pos += 1
    last_i = i_sym
    while True:
        row, pos = _read_freq_table0(data, pos)
        F[i_sym] = row
        if rle_i > 0:
            rle_i -= 1
            i_sym += 1
        else:
            nxt = data[pos]
            pos += 1
            if nxt == last_i + 1:
                rle_i = data[pos]
                pos += 1
            i_sym = nxt
            if i_sym == 0:
                break
        last_i = i_sym
    tables = {}
    for ctx, row in F.items():
        lookup = np.zeros(TOTFREQ, dtype=np.uint8)
        fstart = np.zeros(256, dtype=np.uint32)
        ffreq = np.zeros(256, dtype=np.uint32)
        c = 0
        for s in sorted(row):
            f = row[s]
            lookup[c:c + f] = s
            fstart[s] = c
            ffreq[s] = f
            c += f
        tables[ctx] = (lookup, fstart, ffreq)
    states = list(struct.unpack_from("<4I", data, pos))
    pos += 16
    out = bytearray(out_sz)
    isz4 = out_sz >> 2
    ctxs = [0, 0, 0, 0]
    dlen = len(data)
    for i in range(isz4):
        for j in range(4):
            x = states[j]
            lookup, fstart, ffreq = tables[ctxs[j]]
            m = x & (TOTFREQ - 1)
            s = int(lookup[m])
            out[j * isz4 + i] = s
            x = int(ffreq[s]) * (x >> TF_SHIFT) + m - int(fstart[s])
            while x < RANS_L and pos < dlen:
                x = (x << 8) | data[pos]
                pos += 1
            states[j] = x
            ctxs[j] = s
    # remainder handled by the 4th state
    for i in range(4 * isz4, out_sz):
        x = states[3]
        lookup, fstart, ffreq = tables[ctxs[3]]
        m = x & (TOTFREQ - 1)
        s = int(lookup[m])
        out[i] = s
        x = int(ffreq[s]) * (x >> TF_SHIFT) + m - int(fstart[s])
        while x < RANS_L and pos < dlen:
            x = (x << 8) | data[pos]
            pos += 1
        states[3] = x
        ctxs[3] = s
    return bytes(out), pos


def rans_decode(data: bytes) -> bytes:
    order = data[0]
    # comp size, raw size
    _csz = struct.unpack_from("<I", data, 1)[0]
    rsz = struct.unpack_from("<I", data, 5)[0]
    if rsz == 0:
        return b""
    try:
        from delly_tpu_torch import native
        out = native.rans_decode(data, rsz)
        if out is not None:
            return out
    except Exception:
        pass
    if order == 0:
        out, _ = _rans_decode_order0(data, 9, rsz)
    elif order == 1:
        out, _ = _rans_decode_order1(data, 9, rsz)
    else:
        raise ValueError(f"rANS order {order} unsupported")
    return out


def _normalize_freqs(counts: np.ndarray) -> np.ndarray:
    """Scale counts to sum to TOTFREQ with every nonzero kept >= 1."""
    total = int(counts.sum())
    if total == 0:
        return counts.astype(np.int64)
    out = np.floor(counts.astype(np.float64) * TOTFREQ / total).astype(np.int64)
    out[(counts > 0) & (out == 0)] = 1
    diff = TOTFREQ - int(out.sum())
    # adjust the most frequent symbol
    k = int(np.argmax(out))
    out[k] += diff
    if out[k] <= 0:
        raise ValueError("freq normalization failed")
    return out


def _write_freq_table0(freqs: np.ndarray) -> bytes:
    syms = [s for s in range(256) if freqs[s] > 0]
    out = bytearray()
    rle = 0
    for k, s in enumerate(syms):
        if rle > 0:
            rle -= 1
        else:
            out.append(s)
            if k > 0 and s == syms[k - 1] + 1:
                # count consecutive run following s
                run = 0
                while (k + run + 1 < len(syms)
                       and syms[k + run + 1] == s + run + 1):
                    run += 1
                out.append(run)
                rle = run
        out += write_itf8(int(freqs[s]))
    out.append(0)
    return bytes(out)


def rans_encode_order0(raw: bytes) -> bytes:
    """Order-0 rANS 4x8 encoder (for the CRAM writer / codec tests)."""
    if len(raw) == 0:
        return struct.pack("<BII", 0, 0, 0)
    counts = np.bincount(np.frombuffer(raw, dtype=np.uint8), minlength=256)
    freqs = _normalize_freqs(counts)
    table = _write_freq_table0(freqs)
    fstart = np.concatenate(([0], np.cumsum(freqs)[:-1]))
    # encode backwards, 4 interleaved states
    states = [RANS_L] * 4
    out_rev = bytearray()
    n = len(raw)
    for i in range(n - 1, -1, -1):
        j = i & 3
        s = raw[i]
        f = int(freqs[s])
        x = states[j]
        xmax = ((RANS_L >> TF_SHIFT) << 8) * f
        while x >= xmax:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + int(fstart[s])
    head = bytearray()
    for j in range(4):
        head += struct.pack("<I", states[j])
    payload = bytes(table) + bytes(head) + bytes(reversed(out_rev))
    return struct.pack("<BII", 0, len(payload), n) + payload


# ---------------------------------------------------------------------
# block layer
# ---------------------------------------------------------------------

METHOD_RAW, METHOD_GZIP, METHOD_BZIP2, METHOD_LZMA, METHOD_RANS = range(5)
# CRAM 3.1 block methods (htscodecs plane, reimplemented from spec)
METHOD_RANSNX16 = 5
METHOD_ARITH = 6
METHOD_FQZ = 7
METHOD_TOK3 = 8
CT_FILE_HEADER, CT_COMP_HEADER, CT_SLICE_HEADER, _CT_RES, CT_EXTERNAL, \
    CT_CORE = range(6)


def read_block_raw(buf: bytes, pos: int):
    """Scan one block: verify CRC, return compressed payload spans."""
    blk_start = pos
    method = buf[pos]
    ctype = buf[pos + 1]
    pos += 2
    content_id, pos = read_itf8(buf, pos)
    csize, pos = read_itf8(buf, pos)
    rsize, pos = read_itf8(buf, pos)
    data = buf[pos:pos + csize]
    pos += csize
    (crc,) = struct.unpack_from("<I", buf, pos)
    if zlib.crc32(buf[blk_start:pos]) & 0xFFFFFFFF != crc:
        raise ValueError("CRAM block CRC mismatch (corrupt file)")
    pos += 4
    return method, ctype, content_id, data, rsize, pos


def decompress_block(method: int, data: bytes, rsize: int) -> bytes:
    if method == METHOD_RAW:
        raw = data
    elif method == METHOD_GZIP:
        raw = gzip.decompress(data)
    elif method == METHOD_BZIP2:
        raw = bz2.decompress(data)
    elif method == METHOD_LZMA:
        raw = lzma.decompress(data)
    elif method == METHOD_RANS:
        raw = rans_decode(data)
    elif method == METHOD_RANSNX16:
        from delly_tpu_torch.io import rans_nx16
        raw, _ = rans_nx16.decode(data, rsize)
    elif method == METHOD_TOK3:
        from delly_tpu_torch.io import tok3
        raw = tok3.decode(data, rsize)
    elif method == METHOD_FQZ:
        from delly_tpu_torch.io import fqzcomp
        raw = fqzcomp.decode_block(data, rsize)
    elif method == METHOD_ARITH:
        from delly_tpu_torch.io import arith_nx
        raw, _ = arith_nx.decode(data, rsize)
    else:
        raise ValueError(
            f"CRAM block compression method {method} not supported")
    if len(raw) != rsize:
        raise ValueError(f"CRAM block size mismatch {len(raw)} != {rsize}")
    return raw


def read_block(buf: bytes, pos: int):
    method, ctype, content_id, data, rsize, pos = read_block_raw(buf, pos)
    return method, ctype, content_id, \
        decompress_block(method, data, rsize), pos


def write_block(method: int, ctype: int, content_id: int,
                raw: bytes, nx16_flags: int = 0,
                payload: bytes | None = None) -> bytes:
    if payload is not None:
        data = payload
    elif method == METHOD_GZIP:
        data = gzip.compress(raw, 6)
    elif method == METHOD_RANS:
        data = rans_encode_order0(raw)
    elif method == METHOD_RANSNX16:
        from delly_tpu_torch.io import rans_nx16
        try:
            data = rans_nx16.encode(raw, nx16_flags)
        except ValueError:
            data = rans_nx16.encode(raw, 0)
    elif method == METHOD_TOK3:
        from delly_tpu_torch.io import tok3
        # raw is a NUL-stop name array (the RN series layout)
        data = tok3.encode(raw.split(b"\x00")[:-1]) if raw else b""
        if not raw:
            method = METHOD_RAW
            data = raw
    else:
        method = METHOD_RAW
        data = raw
    out = bytearray([method, ctype])
    out += write_itf8(content_id)
    out += write_itf8(len(data))
    out += write_itf8(len(raw))
    out += data
    out += struct.pack("<I", zlib.crc32(bytes(out)) & 0xFFFFFFFF)
    return bytes(out)


# ---------------------------------------------------------------------
# bit reader (core block codecs)
# ---------------------------------------------------------------------


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0

    def write_bits(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.cur = (self.cur << 1) | ((v >> k) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.cur)
                self.cur = 0
                self.nbits = 0

    def finish(self) -> bytes:
        if self.nbits:
            self.out.append(self.cur << (8 - self.nbits))
            self.cur = 0
            self.nbits = 0
        return bytes(self.out)


# ---------------------------------------------------------------------
# field encodings
# ---------------------------------------------------------------------

ENC_NULL, ENC_EXTERNAL, _ENC_GOLOMB, ENC_HUFFMAN, ENC_BYTE_ARRAY_LEN, \
    ENC_BYTE_ARRAY_STOP, ENC_BETA = range(7)


def parse_encoding(buf: bytes, pos: int):
    codec, pos = read_itf8(buf, pos)
    nbytes, pos = read_itf8(buf, pos)
    params = buf[pos:pos + nbytes]
    pos += nbytes
    return (codec, params), pos


class Decoder:
    """One data-series decoder bound to core/external streams."""

    def __init__(self, spec, streams, core):
        self.codec, params = spec
        self.streams = streams
        self.core = core
        p = 0
        if self.codec == ENC_EXTERNAL:
            self.cid, p = read_itf8(params, p)
            self.off = 0
            self._vals = None
            self._vi = 0
        elif self.codec == ENC_HUFFMAN:
            nal, p = read_itf8(params, p)
            alphabet = []
            for _ in range(nal):
                v, p = read_itf8_signed(params, p)
                alphabet.append(v)
            nlen, p = read_itf8(params, p)
            lens = []
            for _ in range(nlen):
                v, p = read_itf8(params, p)
                lens.append(v)
            self.alphabet = alphabet
            self.lens = lens
            self._build_huffman()
        elif self.codec == ENC_BETA:
            self.offset, p = read_itf8_signed(params, p)
            self.nbits, p = read_itf8(params, p)
        elif self.codec == ENC_BYTE_ARRAY_STOP:
            self.stop = params[0]
            self.cid, p = read_itf8(params, 1)
            self.off = 0
        elif self.codec == ENC_BYTE_ARRAY_LEN:
            lenc, p = parse_encoding(params, p)
            venc, p = parse_encoding(params, p)
            self.len_dec = Decoder(lenc, streams, core)
            self.val_dec = Decoder(venc, streams, core)
        elif self.codec == ENC_NULL:
            pass
        else:
            raise ValueError(f"CRAM encoding codec {self.codec} unsupported")

    def _build_huffman(self):
        # canonical codes ordered by (len, symbol order in alphabet)
        pairs = sorted(zip(self.lens, range(len(self.alphabet))))
        codes = []
        code = 0
        prev_len = pairs[0][0] if pairs else 0
        for ln, idx in pairs:
            code <<= (ln - prev_len)
            prev_len = ln
            codes.append((ln, code, self.alphabet[idx]))
            code += 1
        self.table = {(ln, c): sym for ln, c, sym in codes}
        self.maxlen = max((ln for ln, _, _ in codes), default=0)
        self.zero_bit = (len(self.alphabet) == 1 and self.lens[0] == 0)
        if self.zero_bit:
            self.only = self.alphabet[0]

    def read_int(self):
        if self.codec == ENC_EXTERNAL:
            if self._vals is None:
                self._predecode()
            if self._vals is not False:
                v = self._vals[self._vi]
                self._vi += 1
                return v
            stream = self.streams[self.cid]
            v, self.off = read_itf8_signed(stream, self.off)
            return v
        if self.codec == ENC_HUFFMAN:
            if self.zero_bit:
                return self.only
            ln = 0
            code = 0
            while ln <= self.maxlen:
                code = (code << 1) | self.core.read_bits(1)
                ln += 1
                sym = self.table.get((ln, code))
                if sym is not None:
                    return sym
            raise ValueError("bad huffman code")
        if self.codec == ENC_BETA:
            return self.core.read_bits(self.nbits) + self.offset
        raise ValueError(f"read_int on codec {self.codec}")

    def _predecode(self):
        """Bulk-decode the whole external ITF-8 stream once (native
        itf8_decode_stream); int-series decoders then read by index.
        Only valid while the decoder is used exclusively for ints, which
        is how data series map to content ids (one series per id)."""
        try:
            from delly_tpu_torch import native
            arr = native.itf8_decode_stream(self.streams[self.cid])
            if arr is not None:
                self._vals = arr.tolist()
                return
        except Exception:
            pass
        self._vals = False

    def read_byte(self):
        if self.codec == ENC_EXTERNAL:
            stream = self.streams[self.cid]
            b = stream[self.off]
            self.off += 1
            return b
        return self.read_int() & 0xFF

    def read_bytes(self, n: int) -> bytes:
        if self.codec == ENC_EXTERNAL:
            stream = self.streams[self.cid]
            out = stream[self.off:self.off + n]
            self.off += n
            return out
        return bytes(self.read_byte() for _ in range(n))

    def read_array(self) -> bytes:
        if self.codec == ENC_BYTE_ARRAY_STOP:
            stream = self.streams[self.cid]
            end = stream.index(self.stop, self.off)
            out = stream[self.off:end]
            self.off = end + 1
            return out
        if self.codec == ENC_BYTE_ARRAY_LEN:
            n = self.len_dec.read_int()
            return self.val_dec.read_bytes(n)
        raise ValueError(f"read_array on codec {self.codec}")


# ---------------------------------------------------------------------
# container / compression header / slice parsing
# ---------------------------------------------------------------------

CRAM_EOF = bytes.fromhex(
    "0f000000ffffffff0fe045"
    "4f46000000000100"
    "05bdd94f0001000606010001000100ee63014b")


def read_container_header(buf: bytes, pos: int):
    (length,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    ref_id, pos = read_itf8_signed(buf, pos)
    start, pos = read_itf8(buf, pos)
    span, pos = read_itf8(buf, pos)
    nrec, pos = read_itf8(buf, pos)
    counter, pos = read_ltf8(buf, pos)
    bases, pos = read_ltf8(buf, pos)
    nblocks, pos = read_itf8(buf, pos)
    nland, pos = read_itf8(buf, pos)
    landmarks = []
    for _ in range(nland):
        v, pos = read_itf8(buf, pos)
        landmarks.append(v)
    pos += 4  # CRC32
    return {
        "length": length, "ref_id": ref_id, "start": start, "span": span,
        "nrec": nrec, "counter": counter, "bases": bases,
        "nblocks": nblocks, "landmarks": landmarks,
    }, pos


class CompressionHeader:
    def __init__(self, raw: bytes):
        pos = 0
        # preservation map
        _size, pos = read_itf8(raw, pos)
        nkeys, pos = read_itf8(raw, pos)
        self.rn = True
        self.ap_delta = True
        self.rr = True
        self.sub_matrix = bytes(5)
        self.tag_dict = [[]]
        for _ in range(nkeys):
            key = raw[pos:pos + 2].decode()
            pos += 2
            if key == "RN":
                self.rn = bool(raw[pos]); pos += 1
            elif key == "AP":
                self.ap_delta = bool(raw[pos]); pos += 1
            elif key == "RR":
                self.rr = bool(raw[pos]); pos += 1
            elif key == "SM":
                self.sub_matrix = raw[pos:pos + 5]; pos += 5
            elif key == "TD":
                tdlen, pos = read_itf8(raw, pos)
                blob = raw[pos:pos + tdlen]
                pos += tdlen
                self.tag_dict = []
                for entry in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                    line = []
                    for k in range(0, len(entry), 3):
                        line.append(entry[k:k + 3])
                    self.tag_dict.append(line)
                if not self.tag_dict:
                    self.tag_dict = [[]]
            else:
                raise ValueError(f"unknown preservation key {key}")
        # data series encodings
        _size, pos = read_itf8(raw, pos)
        nenc, pos = read_itf8(raw, pos)
        self.encodings = {}
        for _ in range(nenc):
            key = raw[pos:pos + 2].decode()
            pos += 2
            enc, pos = parse_encoding(raw, pos)
            self.encodings[key] = enc
        # tag encodings
        _size, pos = read_itf8(raw, pos)
        ntag, pos = read_itf8(raw, pos)
        self.tag_encodings = {}
        for _ in range(ntag):
            key, pos = read_itf8(raw, pos)
            enc, pos = parse_encoding(raw, pos)
            self.tag_encodings[key] = enc

    def decode_matrix(self):
        """sub matrix: per ref base (ACGTN), 2-bit code per alt base."""
        table = {}
        bases = b"ACGTN"
        for ri, r in enumerate(bases):
            alts = [b for b in bases if b != r]
            byte = self.sub_matrix[ri]
            for k, alt in enumerate(alts):
                code = (byte >> (6 - 2 * k)) & 3
                table[(r, code)] = alt
        return table


def parse_slice_header(raw: bytes):
    pos = 0
    ref_id, pos = read_itf8_signed(raw, pos)
    start, pos = read_itf8(raw, pos)
    span, pos = read_itf8(raw, pos)
    nrec, pos = read_itf8(raw, pos)
    counter, pos = read_ltf8(raw, pos)
    nblocks, pos = read_itf8(raw, pos)
    nids, pos = read_itf8(raw, pos)
    ids = []
    for _ in range(nids):
        v, pos = read_itf8(raw, pos)
        ids.append(v)
    embed_ref, pos = read_itf8_signed(raw, pos)
    md5 = raw[pos:pos + 16]
    pos += 16
    return {"ref_id": ref_id, "start": start, "span": span, "nrec": nrec,
            "counter": counter, "nblocks": nblocks, "ids": ids,
            "embed_ref": embed_ref, "md5": md5}


# ---------------------------------------------------------------------
# record decode
# ---------------------------------------------------------------------

BAM_FUNMAP = 4
BAM_FMUNMAP = 8
BAM_FREVERSE = 16
BAM_FMREVERSE = 32

_SEQ_NT16_MAP = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_NT16_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in _SEQ_NT16_MAP.items():
    _NT16_LUT[ord(_c)] = _i
    _NT16_LUT[ord(_c.lower())] = _i
CIGAR_OPS = "MIDNSHP=X"


def _decode_slice(ch: CompressionHeader, sh, core_raw, streams, refs,
                  header_names, slice_refseq):
    """Decode one slice into a list of record dicts."""
    core = BitReader(core_raw)

    def dec(key):
        spec = ch.encodings.get(key)
        if spec is None:
            return None
        return Decoder(spec, streams, core)

    D = {k: dec(k) for k in (
        "BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS",
        "NF", "TL", "FN", "FC", "FP", "DL", "BA", "BS", "IN", "SC", "HC",
        "PD", "RS", "BB", "QQ", "QS", "MQ")}
    tag_decoders = {k: Decoder(v, streams, core)
                    for k, v in ch.tag_encodings.items()}
    sub = ch.decode_matrix()

    records = []
    last_ap = sh["start"]
    for _ in range(sh["nrec"]):
        r = {}
        bf = D["BF"].read_int()
        cf = D["CF"].read_int()
        if sh["ref_id"] == -2:
            tid = D["RI"].read_int()
        else:
            tid = sh["ref_id"]
        rl = D["RL"].read_int()
        ap = D["AP"].read_int()
        if ch.ap_delta:
            ap = last_ap + ap
            last_ap = ap
        rg = D["RG"].read_int() if D["RG"] else -1
        qname = b""
        if ch.rn:
            qname = D["RN"].read_array()
        mate_flags = 0
        ns = -1
        np_ = -1
        ts = 0
        nf = -1
        if cf & 0x2:  # detached
            mate_flags = D["MF"].read_int()
            if not ch.rn:
                qname = D["RN"].read_array()
            ns = D["NS"].read_int()
            np_ = D["NP"].read_int() - 1  # NP is 1-based (spec 8.2)
            ts = D["TS"].read_int()
        elif cf & 0x4:  # mate downstream
            nf = D["NF"].read_int()
        tl = D["TL"].read_int() if D["TL"] else 0
        tags = []
        for tag3 in ch.tag_dict[tl]:
            key = (tag3[0] << 16) | (tag3[1] << 8) | tag3[2]
            val = tag_decoders[key].read_array()
            tags.append((tag3, val))

        seq = bytearray(b"N" * rl)
        quals = bytearray(b"\xff" * rl)
        cigar = []
        mapq = 0
        if not (bf & BAM_FUNMAP):
            fn = D["FN"].read_int()
            # reference slice for this record
            ref = None
            if ch.rr:
                if sh["ref_id"] == -2:
                    ref = refs(tid) if tid >= 0 else None
                else:
                    ref = slice_refseq
            feats = []
            fpos = 0
            for _f in range(fn):
                fc = D["FC"].read_byte()
                fdelta = D["FP"].read_int()
                fpos += fdelta
                code = chr(fc)
                if code == "X":
                    feats.append((fpos, code, D["BS"].read_byte()))
                elif code == "B":
                    b = D["BA"].read_byte()
                    q = D["QS"].read_byte()
                    feats.append((fpos, code, (b, q)))
                elif code == "I":
                    feats.append((fpos, code, D["IN"].read_array()))
                elif code == "S":
                    feats.append((fpos, code, D["SC"].read_array()))
                elif code == "D":
                    feats.append((fpos, code, D["DL"].read_int()))
                elif code == "i":
                    feats.append((fpos, code, D["BA"].read_byte()))
                elif code == "N":
                    feats.append((fpos, code, D["RS"].read_int()))
                elif code == "H":
                    feats.append((fpos, code, D["HC"].read_int()))
                elif code == "P":
                    feats.append((fpos, code, D["PD"].read_int()))
                elif code == "b":
                    feats.append((fpos, code, D["BB"].read_array()))
                elif code == "q":
                    feats.append((fpos, code, D["QQ"].read_array()))
                elif code == "Q":
                    feats.append((fpos, code, D["QS"].read_byte()))
                else:
                    raise ValueError(f"unknown feature code {code!r}")
            seq, cigar = _reconstruct(rl, ap, feats, ref, sub, quals)
            mapq = D["MQ"].read_int()
            if cf & 0x1:
                quals[:] = D["QS"].read_bytes(rl)
            if cf & 0x8:  # sequence "*": structure only (spec 8.2)
                seq = b""
                quals = bytearray(b"")
        else:
            for i in range(rl):
                seq[i] = D["BA"].read_byte()
            seq = bytes(seq)
            cigar = []
            if cf & 0x1:
                quals[:] = D["QS"].read_bytes(rl)

        records.append({
            "bf": bf, "cf": cf, "tid": tid, "pos": ap - 1, "rl": rl,
            "rg": rg, "qname": bytes(qname), "mf": mate_flags, "ns": ns,
            "np": np_, "ts": ts, "nf": nf, "tags": tags, "seq": bytes(seq),
            "qual": bytes(quals), "cigar": cigar, "mapq": mapq,
        })
    return records


def _reconstruct(rl, ap, feats, ref, sub, quals):
    """Rebuild sequence + cigar from features (spec section 10.3)."""
    seq = bytearray(rl)
    cigar = []

    def add_op(op, n):
        if n <= 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += n
        else:
            cigar.append([op, n])

    rpos = 0          # read cursor (0-based)
    ref_off = ap - 1  # reference cursor (0-based)

    def fill_match(n):
        nonlocal rpos, ref_off
        if n <= 0:
            return
        if ref is not None:
            avail = max(0, min(n, len(ref) - ref_off))
        else:
            avail = 0
        if avail > 0:
            seq[rpos:rpos + avail] = ref[ref_off:ref_off + avail]
        if avail < n:
            seq[rpos + avail:rpos + n] = b"N" * (n - avail)
        add_op("M", n)
        rpos += n
        ref_off += n

    for fpos, code, payload in feats:
        gap = (fpos - 1) - rpos
        fill_match(gap)
        if code == "X":
            rbase = (ref[ref_off] if ref is not None
                     and ref_off < len(ref) else ord("N"))
            rbase_up = rbase & ~0x20 if ord('a') <= rbase <= ord('z') else rbase
            if rbase_up not in b"ACGTN":
                rbase_up = ord("N")
            seq[rpos] = sub.get((rbase_up, payload), ord("N"))
            add_op("M", 1)
            rpos += 1
            ref_off += 1
        elif code == "B":
            seq[rpos] = payload[0]
            quals[rpos] = payload[1]
            add_op("M", 1)
            rpos += 1
            ref_off += 1
        elif code == "I":
            seq[rpos:rpos + len(payload)] = payload
            add_op("I", len(payload))
            rpos += len(payload)
        elif code == "i":
            seq[rpos] = payload
            add_op("I", 1)
            rpos += 1
        elif code == "S":
            seq[rpos:rpos + len(payload)] = payload
            add_op("S", len(payload))
            rpos += len(payload)
        elif code == "D":
            add_op("D", payload)
            ref_off += payload
        elif code == "N":
            add_op("N", payload)
            ref_off += payload
        elif code == "H":
            add_op("H", payload)
        elif code == "P":
            add_op("P", payload)
        elif code == "b":
            seq[rpos:rpos + len(payload)] = payload
            add_op("M", len(payload))
            rpos += len(payload)
            ref_off += len(payload)
        elif code == "q":
            quals[rpos:rpos + len(payload)] = payload
        elif code == "Q":
            quals[rpos] = payload
    fill_match(rl - rpos)
    return bytes(seq), [(op, n) for op, n in cigar]


def _resolve_mates(records):
    """Mate-downstream (NF) pairing within a slice (spec 8.2; htslib
    cram_decode.c pair resolution)."""
    n = len(records)
    for i, r in enumerate(records):
        nf = r["nf"]
        if nf < 0:
            continue
        j = i + nf + 1
        if j >= n:
            continue
        m = records[j]
        m["qname"] = r["qname"]
        r["ns"], r["np"] = m["tid"], m["pos"]
        m["ns"], m["np"] = r["tid"], r["pos"]
        # mate flag reconstruction
        if m["bf"] & BAM_FREVERSE:
            r["bf"] |= BAM_FMREVERSE
        if m["bf"] & BAM_FUNMAP:
            r["bf"] |= BAM_FMUNMAP
        if r["bf"] & BAM_FREVERSE:
            m["bf"] |= BAM_FMREVERSE
        if r["bf"] & BAM_FUNMAP:
            m["bf"] |= BAM_FMUNMAP
        # template size: leftmost gets +, rightmost -
        r_end = r["pos"] + _ref_span(r)
        m_end = m["pos"] + _ref_span(m)
        left = min(r["pos"], m["pos"])
        right = max(r_end, m_end)
        span = right - left
        if r["pos"] <= m["pos"]:
            r["ts"], m["ts"] = span, -span
        else:
            r["ts"], m["ts"] = -span, span
    for r in records:
        if r["nf"] >= 0 or r["cf"] & 0x2:
            continue
        # second half of an NF pair: fields were back-filled above


def _ref_span(r):
    span = 0
    for op, n in r["cigar"]:
        if op in "MDN=X":
            span += n
    return span if span else r["rl"]


def _bam_encode_record(r, rg_names):
    """Serialize one decoded CRAM record as an uncompressed BAM record."""
    qname = r["qname"] or b"*"
    name = qname + b"\x00"
    cig = b""
    for op, n in r["cigar"]:
        cig += struct.pack("<I", (n << 4) | CIGAR_OPS.index(op))
    seq = r["seq"]
    nseq = len(seq)
    codes = _NT16_LUT[np.frombuffer(seq, dtype=np.uint8)]
    if nseq % 2:
        codes = np.concatenate([codes, np.zeros(1, dtype=np.uint8)])
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    aux = b""
    if 0 <= r["rg"] < len(rg_names):
        aux += b"RG" + b"Z" + rg_names[r["rg"]] + b"\x00"
    for tag3, val in r["tags"]:
        aux += tag3[:2] + tag3[2:3] + val
    flag = r["bf"]
    mtid = r["ns"]
    mpos = r["np"]
    body = struct.pack(
        "<iiBBHHHiiii", r["tid"], r["pos"], len(name), r["mapq"],
        0, len(r["cigar"]), flag, nseq, mtid, mpos, r["ts"])
    body += name + cig + packed + r["qual"][:nseq] + aux
    return struct.pack("<i", len(body)) + body


def cram_to_bam_bytes(raw: bytes, genome: str | None = None) -> bytes:
    """Decode a CRAM 3.x byte stream into an uncompressed BAM stream."""
    if raw[:4] != b"CRAM":
        raise ValueError("not a CRAM file")
    major, minor = raw[4], raw[5]
    if major != 3:
        raise ValueError(f"CRAM {major}.{minor} unsupported (need 3.x)")
    pos = 26  # magic + version + 20-byte file id
    # file header container: SAM text
    hdr, pos = read_container_header(raw, pos)
    end0 = pos + hdr["length"]
    _m, ctype, _cid, htext, pos = read_block(raw, pos)
    if ctype != CT_FILE_HEADER:
        raise ValueError("first block is not the SAM header")
    pos = end0
    (tlen,) = struct.unpack_from("<i", htext, 0)
    sam_text = htext[4:4 + tlen].decode()

    # reference dictionary from SAM text (@SQ order defines tids)
    names = []
    lengths = []
    rg_names = []
    for line in sam_text.split("\n"):
        if line.startswith("@SQ"):
            sn = ln = None
            for f in line.split("\t"):
                if f.startswith("SN:"):
                    sn = f[3:]
                elif f.startswith("LN:"):
                    ln = int(f[3:])
            names.append(sn)
            lengths.append(ln or 0)
        elif line.startswith("@RG"):
            for f in line.split("\t"):
                if f.startswith("ID:"):
                    rg_names.append(f[3:].encode())

    fasta = None
    ref_cache = {}

    def get_ref(tid):
        if tid < 0 or tid >= len(names):
            return None
        if tid not in ref_cache:
            nonlocal fasta
            if fasta is None and genome:
                from delly_tpu_torch.io.fasta import FastaFile
                fasta = FastaFile(genome)
            if fasta is not None and fasta.has_seq(names[tid]):
                ref_cache[tid] = fasta.fetch(names[tid]).upper().encode()
            else:
                ref_cache[tid] = None
        return ref_cache[tid]

    out = bytearray()
    out += b"BAM\x01" + struct.pack("<i", len(sam_text.encode()))
    out += sam_text.encode()
    out += struct.pack("<i", len(names))
    for nm, ln in zip(names, lengths):
        nb = (nm or "").encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)

    n = len(raw)
    # Phase 1: walk containers/blocks sequentially (cheap), collecting
    # per-slice work items; phase 2 decodes slices on a thread pool (the
    # native transcoder and codecs release the GIL, slices are
    # independent) and concatenates results in file order.
    work = []
    while pos < n:
        if raw[pos:pos + len(CRAM_EOF)] == CRAM_EOF:
            break
        ch_hdr, pos = read_container_header(raw, pos)
        cend = pos + ch_hdr["length"]
        if ch_hdr["nrec"] == 0 and ch_hdr["nblocks"] == 0:
            pos = cend
            continue
        # first block: compression header
        _m, ctype, _cid, chraw, pos = read_block(raw, pos)
        if ctype != CT_COMP_HEADER:
            raise ValueError("expected compression header block")
        ch = CompressionHeader(chraw)
        while pos < cend:
            _m, ctype, _cid, sraw, pos = read_block(raw, pos)
            if ctype != CT_SLICE_HEADER:
                raise ValueError("expected slice header block")
            sh = parse_slice_header(sraw)
            zblocks = []
            for _b in range(sh["nblocks"]):
                m2, ct2, cid2, zdata, rsize, pos = read_block_raw(raw, pos)
                zblocks.append((m2, ct2, cid2, zdata, rsize))
            work.append((ch, sh, zblocks))
        pos = cend

    def decode_one(item):
        ch, sh, zblocks = item
        core_raw = b""
        streams = {}
        embedded_ref = None
        for m2, ct2, cid2, zdata, rsize in zblocks:
            braw = decompress_block(m2, zdata, rsize)
            if ct2 == CT_CORE:
                core_raw = braw
            elif ct2 == CT_EXTERNAL:
                streams[cid2] = braw
                if cid2 == sh["embed_ref"]:
                    embedded_ref = braw
        if ch.rr:
            if embedded_ref is not None:
                srs = (b"\x00" * (sh["start"] - 1)) + embedded_ref
            elif sh["ref_id"] >= 0:
                srs = get_ref(sh["ref_id"])
            else:
                srs = None
        else:
            srs = None
        if sh["ref_id"] != -2 and not core_raw:
            nat = _decode_slice_native(ch, sh, streams, srs, rg_names)
            if nat is not None:
                return nat
        recs = _decode_slice(ch, sh, core_raw, streams, get_ref,
                             names, srs)
        _resolve_mates(recs)
        part = bytearray()
        for r in recs:
            part += _bam_encode_record(r, rg_names)
        return bytes(part)

    # materialize references up-front (get_ref caches; avoids races)
    for item in work:
        if item[0].rr and item[1]["ref_id"] >= 0 \
                and item[1]["embed_ref"] < 0:
            get_ref(item[1]["ref_id"])
    if len(work) > 1:
        from concurrent.futures import ThreadPoolExecutor
        nthreads = min(8, os.cpu_count() or 1, len(work))
        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            parts = list(ex.map(decode_one, work))
    else:
        parts = [decode_one(item) for item in work]
    for part in parts:
        out += part
    return bytes(out)


def is_cram(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(4) == b"CRAM"


# ---------------------------------------------------------------------
# writer (round-trip validation / interop tests)
# ---------------------------------------------------------------------

_SM_CANON = bytes([0x1B] * 5)  # codes 0..3 for alts in ACGTN-minus-ref order


def _split_aux(aux: bytes):
    """Split a BAM aux blob into (tag3, payload-bytes) pairs."""
    out = []
    pos = 0
    n = len(aux)
    sizes = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
             ord("i"): 4, ord("I"): 4, ord("f"): 4, ord("A"): 1}
    while pos + 3 <= n:
        tag3 = aux[pos:pos + 3]
        typ = aux[pos + 2]
        pos += 3
        if typ in sizes:
            sz = sizes[typ]
            out.append((tag3, aux[pos:pos + sz]))
            pos += sz
        elif typ in (ord("Z"), ord("H")):
            end = aux.index(b"\x00", pos)
            out.append((tag3, aux[pos:end + 1]))
            pos = end + 1
        elif typ == ord("B"):
            sub = aux[pos]
            (cnt,) = struct.unpack_from("<I", aux, pos + 1)
            sz = 5 + sizes[sub] * cnt
            out.append((tag3, aux[pos:pos + sz]))
            pos += sz
        else:
            break
    return out


def write_cram(bam, genome: str, path: str, use_rans: bool = True,
               slice_size: int = 5000, version=(3, 0),
               use_fqz: bool = False) -> None:
    """Write a CRAM 3.x file from an open BamFile (tests / interop).

    version=(3, 1) emits the CRAM 3.1 codec plane: rANS Nx16 external
    blocks (order-0/1 + RLE/PACK per series) and the tok3 name
    tokeniser for the RN series.

    Mapped reads are stored reference-based ('X' substitutions, I/D/S/N
    features); mates found downstream in the same slice use the NF
    (mate-downstream) encoding, others are detached.
    """
    from delly_tpu_torch.io.fasta import FastaFile
    fasta = FastaFile(genome)
    refs = {}

    def get_ref(tid):
        if tid not in refs:
            name = bam.header.names[tid]
            refs[tid] = (fasta.fetch(name).upper().encode()
                         if fasta.has_seq(name) else b"")
        return refs[tid]

    recs = list(bam.records())
    out = bytearray()
    out += b"CRAM" + bytes(version) + b"\x00" * 20

    sam_text = bam.header.text
    if not sam_text.endswith("\n"):
        sam_text += "\n"
    hblob = struct.pack("<i", len(sam_text.encode())) + sam_text.encode()
    hblock = write_block(METHOD_GZIP, CT_FILE_HEADER, 0, hblob)
    out += _container_header(len(hblock), -1, 0, 0, 0, 1, [0]) + hblock

    rg_ids = []
    for line in sam_text.split("\n"):
        if line.startswith("@RG"):
            for f in line.split("\t"):
                if f.startswith("ID:"):
                    rg_ids.append(f[3:].encode())

    for s0 in range(0, len(recs), slice_size):
        chunk = recs[s0:s0 + slice_size]
        out += _write_container(chunk, get_ref, rg_ids, use_rans,
                                version, use_fqz)
    out += CRAM_EOF
    with open(path, "wb") as fh:
        fh.write(out)


def _container_header(length, ref_id, start, span, nrec, nblocks,
                      landmarks):
    body = bytearray()
    body += write_itf8(ref_id & 0xFFFFFFFF)
    body += write_itf8(start)
    body += write_itf8(span)
    body += write_itf8(nrec)
    body += write_ltf8(0)
    body += write_ltf8(0)
    body += write_itf8(nblocks)
    body += write_itf8(len(landmarks))
    for lm in landmarks:
        body += write_itf8(lm)
    out = struct.pack("<i", length) + bytes(body)
    return out + struct.pack("<I", zlib.crc32(out) & 0xFFFFFFFF)


def _enc_external(cid):
    params = write_itf8(cid)
    return write_itf8(ENC_EXTERNAL) + write_itf8(len(params)) + params


def _enc_bytearray_stop(stop, cid):
    params = bytes([stop]) + write_itf8(cid)
    return (write_itf8(ENC_BYTE_ARRAY_STOP) + write_itf8(len(params))
            + params)


def _enc_bytearray_len(len_cid, val_cid):
    params = _enc_external(len_cid) + _enc_external(val_cid)
    return write_itf8(ENC_BYTE_ARRAY_LEN) + write_itf8(len(params)) + params


def _write_container(chunk, get_ref, rg_ids, use_rans,
                     version=(3, 0), use_fqz=False):
    from delly_tpu_torch.io.bam import CIGAR_CHARS

    streams = {}
    ids = {}
    nid = [1]
    qs_lens = []  # QS consumption boundaries (fqzcomp record model)

    def st(key):
        if key not in ids:
            ids[key] = nid[0]
            nid[0] += 1
            streams[ids[key]] = bytearray()
        return streams[ids[key]]

    def put_int(key, v):
        st(key).extend(write_itf8(v & 0xFFFFFFFF))

    def put_byte(key, v):
        st(key).append(v & 0xFF)

    def put_stop_array(key, data):
        st(key).extend(bytes(data) + b"\x00")

    # tag dictionary
    tag_lines = []
    line_index = {}
    rec_aux = []
    for rec in chunk:
        pairs = _split_aux(rec._aux)
        line = tuple(p[0] for p in pairs)
        if line not in line_index:
            line_index[line] = len(tag_lines)
            tag_lines.append(line)
        rec_aux.append((line_index[line], pairs))

    # mate-downstream detection
    by_name = {}
    for i, rec in enumerate(chunk):
        by_name.setdefault(rec.qname, []).append(i)
    nf_of = {}
    for name, idxs in by_name.items():
        if len(idxs) != 2:
            continue
        i, j = idxs
        a, b = chunk[i], chunk[j]
        # NF pairing loses the stored mate fields: use it only when the
        # spec reconstruction reproduces them exactly (htslib does the
        # same check in cram_encode).
        if a.mtid != b.tid or a.mpos != b.pos:
            continue
        if b.mtid != a.tid or b.mpos != a.pos:
            continue
        exp_a = (0x20 if b.flag & 0x10 else 0) | (0x8 if b.flag & 0x4 else 0)
        exp_b = (0x20 if a.flag & 0x10 else 0) | (0x8 if a.flag & 0x4 else 0)
        if (a.flag & 0x28) != exp_a or (b.flag & 0x28) != exp_b:
            continue
        a_end = a.pos + a.alignment_length()
        b_end = b.pos + b.alignment_length()
        span = max(a_end, b_end) - min(a.pos, b.pos)
        if a.pos <= b.pos:
            exp_ts_a, exp_ts_b = span, -span
        else:
            exp_ts_a, exp_ts_b = -span, span
        if a.tlen != exp_ts_a or b.tlen != exp_ts_b:
            continue
        nf_of[i] = j - i - 1

    tids = {rec.tid for rec in chunk}
    multiref = len(tids) != 1
    slice_ref = -2 if multiref else next(iter(tids))
    ap0 = chunk[0].pos + 1 if chunk else 0
    # AP deltas start from the slice header's start, which is 0 for a
    # multi-reference slice (the readers start there)
    last_ap = 0 if multiref else ap0

    sub_decode = {}
    bases5 = b"ACGTN"
    for r in bases5:
        alts = [b for b in bases5 if b != r]
        for k, alt in enumerate(alts):
            sub_decode[(r, alt)] = k  # code == rank (matrix 0x1B rows)

    max_end = 0
    for i, rec in enumerate(chunk):
        bf = rec.flag
        no_seq = (rec.l_qseq == 0 and rec.n_cigar > 0
                  and not (rec.flag & 4))
        cf = 0 if no_seq else 0x1  # quals preserved unless SEQ "*"
        if no_seq:
            cf |= 0x8
        detached = False
        if i in nf_of:
            cf |= 0x4
        elif rec.flag & 0x1 and not any(
                k in nf_of and k + nf_of[k] + 1 == i for k in by_name.get(
                    rec.qname, [])):
            # not the second of an NF pair -> detached
            second_of_nf = any(
                j == i for k, d in nf_of.items() for j in [k + d + 1])
            if not second_of_nf:
                detached = True
                cf |= 0x2
        put_int("BF", bf)
        put_int("CF", cf)
        if multiref:
            put_int("RI", rec.tid)
        if no_seq:
            rl_out = sum(int(l) for o, l in zip(rec.cigar_ops,
                                                rec.cigar_lens)
                         if o in (0, 1, 4, 7, 8))
        else:
            rl_out = rec.l_qseq
        put_int("RL", rl_out)
        ap = rec.pos + 1
        put_int("AP", ap - last_ap)
        last_ap = ap
        put_int("RG", -1)
        put_stop_array("RN", rec.qname.encode())
        if detached:
            mf = 0
            if rec.flag & 0x20:
                mf |= 1
            if rec.flag & 0x8:
                mf |= 2
            put_int("MF", mf)
            put_int("NS", rec.mtid)
            put_int("NP", rec.mpos + 1)
            put_int("TS", rec.tlen)
        elif cf & 0x4:
            put_int("NF", nf_of[i])
        tl, pairs = rec_aux[i]
        put_int("TL", tl)
        for tag3, payload in pairs:
            key = f"T{tag3[0]:02x}{tag3[1]:02x}{tag3[2]:02x}"
            st(key + "L").extend(write_itf8(len(payload)))
            st(key + "V").extend(bytes(payload))

        seq = rec.seq.upper().encode()
        quals = bytes(rec.qual)
        if no_seq:
            # SEQ "*" with a CIGAR (secondary/supplementary): structure
            # only — synthesize N bases for feature payloads (discarded
            # by the CF 0x8 decode path)
            seq = b"N" * rl_out
            quals = b"\xff" * rl_out
        if not (rec.flag & 4):
            ref = get_ref(rec.tid)
            feats = []
            rpos = 0
            roff = rec.pos
            for op, ol in zip(rec.cigar_ops, rec.cigar_lens):
                ol = int(ol)
                op_ch = CIGAR_CHARS[op]
                if op_ch in "M=X":
                    for k in range(ol):
                        b = seq[rpos + k]
                        rb = (ref[roff + k] if roff + k < len(ref)
                              else ord("N"))
                        if b != rb:
                            code = sub_decode.get((rb if rb in bases5
                                                   else ord("N"), b))
                            if code is not None:
                                feats.append((rpos + k + 1, "X", code))
                            else:
                                feats.append((rpos + k + 1, "B",
                                              (b, quals[rpos + k])))
                    rpos += ol
                    roff += ol
                elif op_ch == "I":
                    feats.append((rpos + 1, "I", seq[rpos:rpos + ol]))
                    rpos += ol
                elif op_ch == "S":
                    feats.append((rpos + 1, "S", seq[rpos:rpos + ol]))
                    rpos += ol
                elif op_ch == "D":
                    feats.append((rpos + 1, "D", ol))
                    roff += ol
                elif op_ch == "N":
                    feats.append((rpos + 1, "N", ol))
                    roff += ol
                elif op_ch == "H":
                    feats.append((rpos + 1, "H", ol))
                elif op_ch == "P":
                    feats.append((rpos + 1, "P", ol))
            put_int("FN", len(feats))
            prev = 0
            for fpos, code, payload in feats:
                put_byte("FC", ord(code))
                put_int("FP", fpos - prev)
                prev = fpos
                if code == "X":
                    put_byte("BS", payload)
                elif code == "B":
                    put_byte("BA", payload[0])
                    put_byte("QS", payload[1])
                    qs_lens.append(1)
                elif code == "I":
                    put_stop_array("IN", payload)
                elif code == "S":
                    put_stop_array("SC", payload)
                elif code in "DNHP":
                    put_int({"D": "DL", "N": "RS", "H": "HC",
                             "P": "PD"}[code], payload)
            put_int("MQ", rec.mapq)
            if cf & 0x1:
                st("QS").extend(quals)
                qs_lens.append(len(quals))
            end = rec.pos + rec.alignment_length()
            max_end = max(max_end, end)
        else:
            for b in seq:
                put_byte("BA", b)
            st("QS").extend(quals)
            qs_lens.append(len(quals))
            max_end = max(max_end, rec.pos + 1)

    # compression header
    td_blob = bytearray()
    for line in tag_lines:
        for tag3 in line:
            td_blob += tag3
        td_blob.append(0)
    pres = bytearray()
    npres = 5
    pres += b"RN" + b"\x01"
    pres += b"AP" + b"\x01"
    pres += b"RR" + b"\x01"
    pres += b"SM" + _SM_CANON
    pres += b"TD" + write_itf8(len(td_blob)) + bytes(td_blob)
    pres_map = write_itf8(npres) + bytes(pres)

    enc = bytearray()
    nenc = 0
    series_keys = [k for k in ids if len(k) == 2]
    for key in series_keys:
        cid = ids[key]
        nenc += 1
        enc += key.encode()
        if key == "RN":
            enc += _enc_bytearray_stop(0, cid)
        elif key in ("IN", "SC"):
            enc += _enc_bytearray_stop(0, cid)
        else:
            enc += _enc_external(cid)
    enc_map = write_itf8(nenc) + bytes(enc)

    tenc = bytearray()
    ntenc = 0
    for key in [k for k in ids
                if k.startswith("T") and len(k) == 8 and k.endswith("L")]:
        c1 = int(key[1:3], 16)
        c2 = int(key[3:5], 16)
        c3 = int(key[5:7], 16)
        ikey = (c1 << 16) | (c2 << 8) | c3
        ntenc += 1
        tenc += write_itf8(ikey)
        tenc += _enc_bytearray_len(ids[key], ids[key[:-1] + "V"])
    tag_map = write_itf8(ntenc) + bytes(tenc)

    chraw = (write_itf8(len(pres_map)) + pres_map
             + write_itf8(len(enc_map)) + enc_map
             + write_itf8(len(tag_map)) + tag_map)
    ch_block = write_block(METHOD_GZIP, CT_COMP_HEADER, 0, chraw)

    # slice header + blocks
    start = ap0 if slice_ref >= 0 else 0
    span = (max_end - start + 1) if slice_ref >= 0 else 0
    ext_ids = sorted(streams)
    sl = bytearray()
    sl += write_itf8(slice_ref & 0xFFFFFFFF)
    sl += write_itf8(start)
    sl += write_itf8(span)
    sl += write_itf8(len(chunk))
    sl += write_ltf8(0)
    sl += write_itf8(len(ext_ids) + 1)  # core + externals
    sl += write_itf8(len(ext_ids))
    for cid in ext_ids:
        sl += write_itf8(cid)
    sl += write_itf8(-1 & 0xFFFFFFFF)  # no embedded ref
    sl += bytes(16)  # md5 (unchecked)
    sl_block = write_block(METHOD_RAW, CT_SLICE_HEADER, 0, bytes(sl))

    blocks = bytearray()
    blocks += sl_block
    blocks += write_block(METHOD_RAW, CT_CORE, 0, b"")
    key_of = {cid: key for key, cid in ids.items()}
    for k, cid in enumerate(ext_ids):
        raw = bytes(streams[cid])
        if version >= (3, 1):
            # CRAM 3.1 codec plane: tok3 names, order-1 qualities,
            # RLE'd flag/feature series, PACK'd base series (encoder
            # falls back to plain order-0 when a transform does not
            # apply)
            from delly_tpu_torch.io import rans_nx16 as _rx
            key = key_of.get(cid, "")
            if key == "RN" and raw:
                blocks += write_block(METHOD_TOK3, CT_EXTERNAL, cid,
                                      raw)
                continue
            if key == "QS" and use_fqz and raw:
                from delly_tpu_torch.io import fqzcomp
                recs_q = []
                a = 0
                for ln in qs_lens:
                    recs_q.append(raw[a:a + ln])
                    a += ln
                assert a == len(raw)
                blocks += write_block(
                    METHOD_FQZ, CT_EXTERNAL, cid, raw,
                    payload=fqzcomp.encode(recs_q, store_lens=True))
                continue
            if key in ("QS", "QQ"):
                fl = _rx.F_ORDER1
            elif key in ("BF", "CF", "FC", "BS", "MQ", "RL", "FN"):
                fl = _rx.F_RLE
            elif key in ("BA", "BB"):
                fl = _rx.F_PACK | _rx.F_RLE
            else:
                fl = 0
            blocks += write_block(METHOD_RANSNX16, CT_EXTERNAL, cid,
                                  raw, nx16_flags=fl)
            continue
        method = METHOD_RANS if (use_rans and k % 2 == 0) else METHOD_GZIP
        blocks += write_block(method, CT_EXTERNAL, cid, raw)

    nblocks = 2 + len(ext_ids) + 1  # comp hdr + slice hdr + core + ext
    body = bytes(ch_block) + bytes(blocks)
    hdr = _container_header(len(body), slice_ref, start, span, len(chunk),
                            nblocks, [len(ch_block)])
    return hdr + body


# ---------------------------------------------------------------------
# native slice transcode (common all-EXTERNAL profile)
# ---------------------------------------------------------------------

_SERIES_ORDER = ["BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP",
                 "TS", "NF", "TL", "FN", "FC", "FP", "DL", "BA", "BS",
                 "IN", "SC", "HC", "PD", "RS", "BB", "QQ", "QS", "MQ",
                 "RN"]
_STOP_SERIES = {"RN", "IN", "SC", "BB", "QQ"}


def _native_profile_cids(ch: CompressionHeader):
    """Map data series -> content id when every present series fits the
    common profile (EXTERNAL ints/bytes; NUL BYTE_ARRAY_STOP arrays;
    BYTE_ARRAY_LEN(EXTERNAL, EXTERNAL) tags; all content ids distinct).
    Returns (cids dict, tag list) or None when out of profile."""
    import struct as _s

    cids = {}
    used = []
    for key, (codec, params) in ch.encodings.items():
        if key not in _SERIES_ORDER:
            return None
        if key in _STOP_SERIES:
            if codec != ENC_BYTE_ARRAY_STOP or params[0] != 0:
                return None
            cid, _ = read_itf8(params, 1)
        else:
            if codec != ENC_EXTERNAL:
                return None
            cid, _ = read_itf8(params, 0)
        cids[key] = cid
        used.append(cid)
    tags = []
    for ikey, (codec, params) in ch.tag_encodings.items():
        if codec != ENC_BYTE_ARRAY_LEN:
            return None
        p = 0
        lenc, p = parse_encoding(params, p)
        venc, p = parse_encoding(params, p)
        if lenc[0] != ENC_EXTERNAL or venc[0] != ENC_EXTERNAL:
            return None
        lcid, _ = read_itf8(lenc[1], 0)
        vcid, _ = read_itf8(venc[1], 0)
        tag3 = bytes(((ikey >> 16) & 0xFF, (ikey >> 8) & 0xFF,
                      ikey & 0xFF))
        tags.append((tag3, lcid, vcid))
        used += [lcid, vcid]
    if len(used) != len(set(used)):
        return None
    return cids, tags


def _decode_slice_native(ch, sh, streams, slice_refseq, rg_names):
    """Decode one slice straight to BAM record bytes via the native
    transcoder, or None when the profile or library is unavailable."""
    import ctypes

    try:
        from delly_tpu_torch import native
        lib = native.get_lib()
    except Exception:
        return None
    if lib is None:
        return None
    prof = _native_profile_cids(ch)
    if prof is None:
        return None
    cids, tags = prof
    # tag dictionary flattening
    tag_index = {t[0]: k for k, t in enumerate(tags)}
    line_offs = [0]
    line_tags = []
    for line in ch.tag_dict:
        for tag3 in line:
            if bytes(tag3) not in tag_index:
                return None
            line_tags.append(tag_index[bytes(tag3)])
        line_offs.append(len(line_tags))
    import numpy as np

    sbufs = []
    slens = np.zeros(len(_SERIES_ORDER), dtype=np.int64)
    for k, key in enumerate(_SERIES_ORDER):
        cid = cids.get(key)
        buf = streams.get(cid, b"") if cid is not None else b""
        sbufs.append(buf)
        slens[k] = len(buf)
    sptr = (ctypes.c_char_p * len(_SERIES_ORDER))(*sbufs)
    tl_bufs = [streams.get(l, b"") for _, l, _ in tags]
    tv_bufs = [streams.get(v, b"") for _, _, v in tags]
    ntags = len(tags)
    tlp = (ctypes.c_char_p * max(ntags, 1))(*(tl_bufs or [b""]))
    tvp = (ctypes.c_char_p * max(ntags, 1))(*(tv_bufs or [b""]))
    tll = np.asarray([len(b) for b in tl_bufs] or [0], dtype=np.int64)
    tvl = np.asarray([len(b) for b in tv_bufs] or [0], dtype=np.int64)
    tag3s = b"".join(t[0] for t in tags) or b"\x00\x00\x00"
    lo = np.asarray(line_offs, dtype=np.int32)
    lt = np.asarray(line_tags or [0], dtype=np.int32)
    rg_blob = b"".join(rg_names)
    rg_offs = np.zeros(len(rg_names) + 1, dtype=np.int32)
    for k, nm in enumerate(rg_names):
        rg_offs[k + 1] = rg_offs[k] + len(nm)
    ref = slice_refseq if slice_refseq is not None else b""
    cap = 4 * sum(int(x) for x in slens) + 128 * sh["nrec"] + 1024
    out_nrec = ctypes.c_int32()
    for _attempt in range(4):
        out = np.zeros(cap, dtype=np.uint8)  # zeros: see native._scratch
        rc = lib.cram_decode_slice(
            sptr, slens.ctypes.data_as(ctypes.c_void_p),
            sh["nrec"], sh["ref_id"], sh["start"], int(ch.ap_delta),
            int(ch.rn), ch.sub_matrix,
            len(line_offs) - 1, lo.ctypes.data_as(ctypes.c_void_p),
            lt.ctypes.data_as(ctypes.c_void_p),
            ntags, tag3s, tlp, tll.ctypes.data_as(ctypes.c_void_p),
            tvp, tvl.ctypes.data_as(ctypes.c_void_p),
            ref, len(ref),
            len(rg_names), rg_offs.ctypes.data_as(ctypes.c_void_p),
            rg_blob,
            out.ctypes.data_as(ctypes.c_void_p), cap,
            ctypes.byref(out_nrec))
        if rc == -2:
            cap *= 4
            continue
        if rc < 0:
            return None
        return out[:rc].tobytes()
    return None


# ---------------------------------------------------------------------
# Streaming region reader (role of htslib's cram_seek + sam_itr_queryi:
# containers carry (ref_id, start, span), so per-chromosome/region
# decode touches only the matching containers — memory O(region))
# ---------------------------------------------------------------------


class CramStream:
    """Container-granular CRAM 3.0 region reader.

    Opens the file, parses the SAM header and walks container headers
    only (a few hundred bytes each); record decode happens per region
    via the same slice decoders the whole-file transcoder uses."""

    def __init__(self, path: str, genome: str | None = None):
        self.path = path
        self._fh = open(path, "rb")
        magic = self._fh.read(6)
        if magic[:4] != b"CRAM":
            raise ValueError(f"{path}: not a CRAM file")
        if magic[4] != 3:
            raise ValueError(f"{path}: CRAM {magic[4]}.{magic[5]} "
                             f"unsupported (need 3.x)")
        pos = 26
        head = self._read_at(pos, 1 << 16)
        hdr, hpos = read_container_header(head, 0)
        need = hpos + hdr["length"]
        if need > len(head):
            head = self._read_at(pos, need)
        _m, ctype, _cid, htext, bpos = read_block(head, hpos)
        if ctype != CT_FILE_HEADER:
            raise ValueError("first block is not the SAM header")
        (tlen,) = struct.unpack_from("<i", htext, 0)
        self.sam_text = htext[4:4 + tlen].decode()
        self.names = []
        self.lengths = []
        self.rg_names = []
        for line in self.sam_text.split("\n"):
            if line.startswith("@SQ"):
                sn = ln = None
                for f in line.split("\t"):
                    if f.startswith("SN:"):
                        sn = f[3:]
                    elif f.startswith("LN:"):
                        ln = int(f[3:])
                self.names.append(sn)
                self.lengths.append(ln or 0)
            elif line.startswith("@RG"):
                for f in line.split("\t"):
                    if f.startswith("ID:"):
                        self.rg_names.append(f[3:].encode())

        self._genome = genome
        self._fasta = None
        self._ref_cache = {}

        # container table: (offset, total_len, ref_id, start, span,
        # nrec, nblocks)
        self.containers = []
        off = pos + need
        while True:
            chunk = self._read_at(off, 1024)
            if len(chunk) < 12 or chunk[:len(CRAM_EOF)] == CRAM_EOF:
                break
            try:
                ch_hdr, hlen = read_container_header(chunk, 0)
            except (struct.error, IndexError):
                chunk = self._read_at(off, 1 << 16)
                ch_hdr, hlen = read_container_header(chunk, 0)
            total = hlen + ch_hdr["length"]
            self.containers.append(
                (off, total, ch_hdr["ref_id"], ch_hdr["start"],
                 ch_hdr["span"], ch_hdr["nrec"], ch_hdr["nblocks"]))
            off += total

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def _read_at(self, off: int, n: int) -> bytes:
        self._fh.seek(off)
        return self._fh.read(n)

    def _get_ref(self, tid):
        if tid < 0 or tid >= len(self.names):
            return None
        if tid not in self._ref_cache:
            if self._fasta is None and self._genome:
                from delly_tpu_torch.io.fasta import FastaFile
                self._fasta = FastaFile(self._genome)
            if self._fasta is not None \
                    and self._fasta.has_seq(self.names[tid]):
                self._ref_cache[tid] = self._fasta.fetch(
                    self.names[tid]).upper().encode()
            else:
                self._ref_cache[tid] = None
        return self._ref_cache[tid]

    def bam_header_bytes(self) -> bytes:
        out = bytearray()
        st = self.sam_text.encode()
        out += b"BAM\x01" + struct.pack("<i", len(st)) + st
        out += struct.pack("<i", len(self.names))
        for nm, ln in zip(self.names, self.lengths):
            nb = (nm or "").encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        return bytes(out)

    def has_reads(self, tid: int) -> bool:
        return any(rid == tid or rid == -2
                   for _o, _t, rid, _s, _sp, nrec, _nb in self.containers
                   if nrec > 0)

    def _decode_container(self, off: int, total: int) -> bytes:
        """Decode one container to BAM record bytes (same slice path as
        cram_to_bam_bytes)."""
        raw = self._read_at(off, total)
        _hdr, pos = read_container_header(raw, 0)
        cend = total
        _m, ctype, _cid, chraw, pos = read_block(raw, pos)
        if ctype != CT_COMP_HEADER:
            raise ValueError("expected compression header block")
        ch = CompressionHeader(chraw)
        parts = []
        while pos < cend:
            _m, ctype, _cid, sraw, pos = read_block(raw, pos)
            if ctype != CT_SLICE_HEADER:
                raise ValueError("expected slice header block")
            sh = parse_slice_header(sraw)
            zblocks = []
            for _b in range(sh["nblocks"]):
                m2, ct2, cid2, zdata, rsize, pos = read_block_raw(raw, pos)
                zblocks.append((m2, ct2, cid2, zdata, rsize))
            parts.append(self._decode_slice_item(ch, sh, zblocks))
        return b"".join(parts)

    def _decode_slice_item(self, ch, sh, zblocks) -> bytes:
        core_raw = b""
        streams = {}
        embedded_ref = None
        for m2, ct2, cid2, zdata, rsize in zblocks:
            braw = decompress_block(m2, zdata, rsize)
            if ct2 == CT_CORE:
                core_raw = braw
            elif ct2 == CT_EXTERNAL:
                streams[cid2] = braw
                if cid2 == sh["embed_ref"]:
                    embedded_ref = braw
        if ch.rr:
            if embedded_ref is not None:
                srs = (b"\x00" * (sh["start"] - 1)) + embedded_ref
            elif sh["ref_id"] >= 0:
                srs = self._get_ref(sh["ref_id"])
            else:
                srs = None
        else:
            srs = None
        if sh["ref_id"] != -2 and not core_raw:
            nat = _decode_slice_native(ch, sh, streams, srs,
                                       self.rg_names)
            if nat is not None:
                return nat
        recs = _decode_slice(ch, sh, core_raw, streams, self._get_ref,
                             self.names, srs)
        _resolve_mates(recs)
        part = bytearray()
        for r in recs:
            part += _bam_encode_record(r, self.rg_names)
        return bytes(part)

    def decode_region(self, tid: int, beg: int, end: int) -> bytes:
        """BAM record bytes for containers that can overlap
        [beg, end) on `tid` (multi-ref -2 containers included; the
        caller masks by tid/pos on the SoA)."""
        parts = []
        for off, total, rid, start, span, nrec, _nb in self.containers:
            if nrec == 0:
                continue
            if rid not in (tid, -2):
                continue
            if rid == tid and span > 0 \
                    and (start - 1 + span <= beg or start - 1 >= end):
                continue
            parts.append(self._decode_container(off, total))
        return b"".join(parts)

    def iter_container_bytes(self):
        """Sequential per-container BAM record bytes (all refs, file
        order) for bounded-memory sampling passes."""
        for off, total, rid, start, span, nrec, _nb in self.containers:
            if nrec == 0:
                continue
            yield self._decode_container(off, total)

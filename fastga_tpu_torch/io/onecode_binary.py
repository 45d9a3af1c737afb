# Copied from fastga_tpu/io/onecode_binary.py; imports point at fastga_tpu_torch.
"""Binary ONEcode: read and write the reference's default binary form.

Format (ONElib.c): an ASCII header (type line, provenance, references,
embedded '~' schema) ending with ``$ <isBig>``, then binary data lines,
then a footer holding the ASCII count lines (#/@/+/%), per-object-type
byte indices ('&' binary INT_LIST lines), serialized list codecs (';'
lines), a '^' end marker, and a trailing 8-byte offset of the footer
start.

Binary data lines: one pack byte ``0x80 | (code<<1) | useCodec`` where
code 0-25='A'-'Z', 26-51='a'-'z', 52=';', 53='&', 54='/', 55='.'
(ONElib.c:196-201).  Fields follow: INTs (and list lengths) in the ltf
variable-length int code (ONElib.c:3725-3845), REALs as raw 8-byte
doubles, CHARs as single bytes.  Lists: INT_LISTs as first value (ltf) +
a used-bytes count + difference-compacted little-endian ints
(compactIntList ONElib.c:902-958); STRINGs as raw bytes; DNA via the
fixed 2-bit little-endian DNAcodec; any list optionally compressed by a
trained 12-bit length-limited Huffman codec (vcEncode/vcDecode
ONElib.c:3479-3720) whose table is serialized in the footer.

The writer trains adaptive 12-bit Huffman list codecs exactly like the
reference (_train_codec / vcCreate semantics; see write_binary below):
the first CODEC_TRAINING bytes of a codec-eligible list type accumulate
byte histograms, then the trained table compresses subsequent lists,
matching ONElib's data sections byte for byte (verified by
tools/refcheck.py --bytecmp).  DNA fields use the fixed DNAcodec.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from . import onecode
from .onecode import (INT, REAL, CHAR, STRING, DNA, INT_LIST, REAL_LIST,
                      STRING_LIST, OneLine, OneSchema, Provenance, Reference,
                      _LIST_TYPES)

_CODE_TO_CHAR = {}
for _i in range(26):
    _CODE_TO_CHAR[_i] = chr(ord("A") + _i)
for _i in range(26):
    _CODE_TO_CHAR[26 + _i] = chr(ord("a") + _i)
_CODE_TO_CHAR[52] = ";"
_CODE_TO_CHAR[53] = "&"
_CODE_TO_CHAR[54] = "/"
_CODE_TO_CHAR[55] = "."
_CHAR_TO_CODE = {v: k for k, v in _CODE_TO_CHAR.items()}

_HEADER_SPECS = {
    "#": (CHAR, INT),
    "@": (CHAR, INT),
    "+": (CHAR, INT),
    "%": (CHAR, CHAR, CHAR, INT),
    "&": (CHAR, INT_LIST),
    ";": (CHAR, STRING),
    "/": (STRING,),
}


# ---------------------------------------------------------------------------
# ltf variable-length int code
# ---------------------------------------------------------------------------


def ltf_read(f) -> int:
    u0 = f.read(1)[0]
    if u0 & 0x40:
        if u0 & 0x80:
            return u0 - 256  # sign-extended single byte
        return u0 & 0x3F
    if u0 & 0x20:
        u1 = f.read(1)[0]
        return ((u0 & 0x1F) << 8) | u1
    n = u0 & 0x0F
    raw = f.read(n + 1)
    val = int.from_bytes(raw, "little")
    if u0 & 0x80:  # negative tag: high bits are all ones
        val |= -1 << (8 * (n + 1))
    return val


def ltf_read_mem(buf, i) -> Tuple[int, int]:
    """ltf decode from a bytes buffer; returns (value, next offset)."""
    u0 = buf[i]
    if u0 & 0x40:
        if u0 & 0x80:
            return u0 - 256, i + 1
        return u0 & 0x3F, i + 1
    if u0 & 0x20:
        return ((u0 & 0x1F) << 8) | buf[i + 1], i + 2
    n = u0 & 0x0F
    val = int.from_bytes(buf[i + 1:i + 2 + n], "little")
    if u0 & 0x80:
        val |= -1 << (8 * (n + 1))
    return val, i + 2 + n


def ltf_write(x: int) -> bytes:
    if x >= 0:
        if x < 0x40:
            return bytes([x | 0x40])
        if x < 0x2000:
            return bytes([(x >> 8) | 0x20, x & 0xFF])
        for n, bound in ((1, 1 << 16), (2, 1 << 24), (3, 1 << 32),
                         (4, 1 << 40), (5, 1 << 48), (6, 1 << 56)):
            if x < bound:
                return bytes([n]) + x.to_bytes(n + 1, "little")
        return bytes([7]) + x.to_bytes(8, "little")
    if x >= -0x40:
        return bytes([x & 0xFF])
    for n, bound in ((1, -(1 << 15)), (2, -(1 << 23)), (3, -(1 << 31)),
                     (4, -(1 << 39)), (5, -(1 << 47)), (6, -(1 << 55))):
        if x >= bound:
            return bytes([0x80 | n]) + (x & ((1 << (8 * (n + 1))) - 1)
                                        ).to_bytes(n + 1, "little")
    return bytes([0x87]) + (x & ((1 << 64) - 1)).to_bytes(8, "little")


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


class VCCodec:
    """Deserialized length-limited Huffman codec (decode only)."""

    def __init__(self, blob: bytes):
        isbig = blob[0]
        if isbig:
            raise ValueError("big-endian ONEcode codec not supported")
        self.esc_code = int.from_bytes(blob[1:5], "little", signed=True)
        self.esc_len = int.from_bytes(blob[5:9], "little", signed=True)
        lens = [0] * 256
        bits = [0] * 256
        p = 9
        for i in range(256):
            lens[i] = blob[p]
            p += 1
            if lens[i] > 0 or i == self.esc_code:
                bits[i] = int.from_bytes(blob[p:p + 2], "little")
                p += 2
        self.lens = lens
        self.bits = bits
        # 16-bit prefix lookup
        look = bytearray(0x10000)
        if self.esc_code >= 0:
            lens[self.esc_code] = self.esc_len
        for i in range(256):
            if lens[i] > 0:
                base = bits[i] << (16 - lens[i])
                for j in range(1 << (16 - lens[i])):
                    look[base + j] = i
        if self.esc_code >= 0:
            lens[self.esc_code] = 0
        self.look = look

    def decode(self, nbits: int, data: bytes, out_len: int) -> bytes:
        if data[0] == 0xFF:
            olen = (nbits >> 3) - 1
            return data[1:1 + olen]
        inbig = data[0] & 0x40
        if inbig:
            raise ValueError("big-endian vc stream not supported")
        b = bytearray(data)
        if nbits >= 64:
            b[0], b[7] = b[7], b[0]
        nw = nbits // 64
        logical = bytearray()
        for w in range(nw):
            logical.extend(b[8 * w:8 * w + 8][::-1])
        logical.extend(b[8 * nw:])
        # big integer bitstream, MSB first
        total = len(logical) * 8
        stream = int.from_bytes(bytes(logical), "big")
        pos = 2  # skip the 2 header bits
        out = bytearray()
        lens = self.lens
        look = self.look
        esc = self.esc_code
        elen = self.esc_len
        while pos < nbits and len(out) < out_len:
            shift = total - pos - 16
            if shift >= 0:
                window = (stream >> shift) & 0xFFFF
            else:
                window = (stream << (-shift)) & 0xFFFF
            c = look[window]
            if c == esc:
                pos += elen
                shift = total - pos - 8
                c = ((stream >> shift) if shift >= 0
                     else (stream << -shift)) & 0xFF
                pos += 8
            else:
                pos += lens[c]
            out.append(c)
        return bytes(out)


HUFF_CUTOFF = 12        # max code length (ONElib.c:2875)
CODEC_TRAINING = 100000  # bytes of raw lists before training (ONElib.c:631)


class VCEncoder:
    """Trainable length-limited Huffman codec — the writer-side mirror of
    the reference's vcCreate/vcAddToTable/vcCreateCodec/vcEncode/
    vcSerialize (ONElib.c:2875-3720; Larmore & Hirschberg length-limited
    coin-filter construction).  Bit-exact with the C implementation,
    including the escape-code convention and the little-endian 64-bit
    word packing."""

    __slots__ = ("hist", "tack", "trained", "lens", "bits",
                 "esc_code", "esc_len", "_lens_lut", "_bits_lut")

    def __init__(self):
        import numpy as np
        self.hist = np.zeros(256, np.int64)
        self.tack = 0
        self.trained = False
        self.lens = None
        self.bits = None
        self.esc_code = -1
        self.esc_len = 0

    def add(self, data) -> None:
        import numpy as np
        arr = np.frombuffer(bytes(data), np.uint8)
        self.hist += np.bincount(arr, minlength=256)
        self.tack += len(arr)

    def create(self, partial: int = 1) -> None:
        """vcCreateCodec: length-limited Huffman from the histogram."""
        hist = self.hist
        ecode = -partial
        codes = []
        for i in range(256):
            if hist[i] > 0:
                codes.append(i)
            elif ecode < 0:
                ecode = i
                codes.append(i)
        ncode = len(codes)
        if ecode < 0:
            partial = 0
        # stable sort by count (glibc qsort is a stable mergesort here)
        codes.sort(key=lambda c: int(hist[c]))

        countb = [int(hist[c]) for c in codes]
        leng = [0] * ncode
        matrix = [[0] * (2 * ncode) for _ in range(HUFF_CUTOFF)]
        lcnt = list(countb)
        llen = ncode - 1
        for L in range(HUFF_CUTOFF - 1, 0, -1):
            j = k = n = 0
            ccnt = []
            while j < ncode or k < llen:
                if k >= llen or (j < ncode
                                 and countb[j] <= lcnt[k] + lcnt[k + 1]):
                    ccnt.append(countb[j])
                    matrix[L][n] = 1
                    j += 1
                else:
                    ccnt.append(lcnt[k] + lcnt[k + 1])
                    matrix[L][n] = 0
                    k += 2
                n += 1
            llen = n - 1
            lcnt = ccnt
        span = 2 * (ncode - 1)
        for L in range(1, HUFF_CUTOFF):
            j = 0
            for n in range(span):
                if matrix[L][n]:
                    leng[j] += 1
                    j += 1
            span = 2 * (span - j)
        for n in range(span):
            leng[n] += 1

        # canonical-descending code assignment (ONElib.c:3130-3146)
        bits = [0] * ncode
        llen = leng[0]
        lbits = (1 << llen) - 1
        bits[0] = lbits
        for n in range(1, ncode):
            while (lbits & 1) == 0:
                lbits >>= 1
                llen -= 1
            lbits -= 1
            while llen < leng[n]:
                lbits = (lbits << 1) | 1
                llen += 1
            bits[n] = lbits

        import numpy as np
        lens256 = np.zeros(256, np.int64)
        bits256 = np.zeros(256, np.int64)
        for i in range(ncode):
            lens256[codes[i]] = leng[i]
            bits256[codes[i]] = bits[i]
        self.lens = lens256
        self.bits = bits256
        if partial:
            self.esc_code = ecode
            self.esc_len = int(lens256[ecode])
            lens256[ecode] = 0
        else:
            self.esc_code = -1
        # per-byte (value, length) LUTs with the escape expansion folded
        # in: an escaped byte emits esc_bits then the raw 8 bits
        vl = bits256.copy()
        ll = lens256.copy()
        if self.esc_code >= 0:
            zero = lens256 == 0
            vl = np.where(zero,
                          (bits256[self.esc_code] << 8)
                          | np.arange(256, dtype=np.int64), vl)
            ll = np.where(zero, self.esc_len + 8, ll)
        self._bits_lut = vl
        self._lens_lut = ll
        self.trained = True

    def encode(self, data) -> Tuple[int, bytes]:
        """vcEncode: -> (nbits, stream bytes of length (nbits+7)//8)."""
        import numpy as np
        raw = bytes(data)
        arr = np.frombuffer(raw, np.uint8)
        ilen = len(arr)
        ibits = ilen << 3
        ll = self._lens_lut[arr]
        tbits = 2 + int(ll.sum())
        if tbits > ibits:
            return ibits + 8, b"\xff" + raw
        vl = self._bits_lut[arr]
        # expand each symbol to HUFF_CUTOFF+8 MSB-first bit slots, mask
        # to the true lengths, compress, pack
        WMAX = HUFF_CUTOFF + 8
        sh = np.arange(WMAX - 1, -1, -1, dtype=np.int64)[None, :]
        bitsmat = (vl[:, None] >> sh) & 1
        # a symbol's code occupies its LOW ll bits, emitted MSB-first:
        # keep slots sh = ll-1 .. 0 (sh descends along the row)
        valid = sh < ll[:, None]
        out_bits = np.empty(tbits, np.uint8)
        out_bits[:2] = 0     # little-endian stream header bits
        out_bits[2:] = bitsmat[valid]
        stream = np.packbits(out_bits)   # MSB-first logical bytes
        nbytes = (tbits + 7) >> 3
        padded = np.zeros(((nbytes + 7) // 8) * 8, np.uint8)
        padded[:len(stream)] = stream[:nbytes]
        nw = tbits // 64
        if nw:
            padded[:8 * nw] = padded[:8 * nw].reshape(nw, 8)[:, ::-1] \
                .reshape(-1)
        out = bytearray(padded[:nbytes].tobytes())
        if tbits >= 64:
            out[0], out[7] = out[7], out[0]
        return tbits, bytes(out)

    def serialize(self) -> bytes:
        """vcSerialize blob (little-endian)."""
        out = bytearray()
        out.append(0)   # isbig
        out += int(self.esc_code).to_bytes(4, "little", signed=True)
        out += int(self.esc_len).to_bytes(4, "little", signed=True)
        for i in range(256):
            out.append(int(self.lens[i]))
            if self.lens[i] > 0 or i == self.esc_code:
                out += int(self.bits[i]).to_bytes(2, "little")
        return bytes(out)


def dna_decode(data: bytes, length: int) -> bytes:
    """2-bit little-endian-within-byte -> 'acgt' bytes."""
    import numpy as np
    arr = np.frombuffer(data, np.uint8)
    codes = np.empty(len(arr) * 4, np.uint8)
    codes[0::4] = arr & 3
    codes[1::4] = (arr >> 2) & 3
    codes[2::4] = (arr >> 4) & 3
    codes[3::4] = (arr >> 6) & 3
    lut = np.frombuffer(b"acgt", np.uint8)
    return lut[codes[:length]].tobytes()


def dna_encode(seq: bytes) -> bytes:
    import numpy as np
    lut = np.zeros(256, np.uint8)
    for i, c in enumerate(b"acgt"):
        lut[c] = i
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    codes = lut[np.frombuffer(seq, np.uint8)]
    pad = (-len(codes)) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    q = codes.reshape(-1, 4)
    packed = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
    return packed.astype(np.uint8).tobytes()


def _decompact_ints(first: int, diffs: bytes, used: int, n: int) -> List[int]:
    out = [first]
    v = first
    for k in range(n - 1):
        chunk = diffs[k * used:(k + 1) * used]
        d = int.from_bytes(chunk, "little",
                           signed=True)
        v += d
        out.append(v)
    return out


def _compact_ints(vals: List[int]) -> Tuple[int, bytes]:
    """-> (usedBytes, diff bytes); mirrors compactIntList."""
    n = len(vals)
    diffs = [vals[i] - vals[i - 1] for i in range(1, n)]
    mask = 0
    for d in diffs:
        mask |= d if d >= 0 else -(d + 1)
    mask >>= 7
    used = 1
    while used < 8 and mask:
        mask >>= 8
        used += 1
    out = b"".join((d & ((1 << (8 * used)) - 1)).to_bytes(used, "little")
                   for d in diffs)
    return used, out


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class BinaryReader:
    """Sequential reader for binary ONEcode files (also accepts the ASCII
    header conventions, so purely-ASCII files should use onecode.OneReader
    instead)."""

    def __init__(self, path, schema: Optional[OneSchema] = None):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        self.schema = schema
        self.filetype = None
        self.subtype = None
        self.provenance: List[Provenance] = []
        self.references: List[Reference] = []
        self.counts: Dict[str, dict] = {}
        self.group_stats: Dict = {}
        self.codecs: Dict[str, VCCodec] = {}
        self.indexes: Dict[str, List[int]] = {}
        self._embedded_schema: List[str] = []
        self._data_start = None
        self._foot_off = None
        self._read_header()
        if self._data_start is not None:
            self._read_footer()
            self._f.seek(self._data_start)

    # -- ASCII line reading in binary mode --------------------------------

    def _ascii_line(self, first: bytes) -> str:
        buf = bytearray(first)
        while True:
            c = self._f.read(1)
            if not c or c == b"\n":
                break
            buf.extend(c)
        return buf.decode("utf-8", "replace")

    def _read_header(self):
        line = self._ascii_line(b"")
        if not line.startswith("1 "):
            raise ValueError(f"{self.path}: not a ONEcode file")
        toks = onecode._Tokens(line)
        toks.next_token()
        tl = int(toks.next_token())
        self.filetype = toks.next_string(tl)
        schema_lines = []
        while True:
            c = self._f.read(1)
            if not c:
                break
            if c[0] & 0x80:
                # binary data line in the header region: data started
                self._f.seek(-1, 1)
                self._data_start = self._f.tell()
                break
            line = self._ascii_line(c)
            if not line.strip():
                continue
            t = line[0]
            toks = onecode._Tokens(line)
            toks.next_token()
            if t == "2":
                sl = int(toks.next_token())
                self.subtype = toks.next_string(sl)
            elif t == "!":
                toks.next_token()
                vals = []
                for _ in range(4):
                    ln = int(toks.next_token())
                    vals.append(toks.next_string(ln))
                self.provenance.append(Provenance(*vals))
            elif t == "<":
                ln = int(toks.next_token())
                fn = toks.next_string(ln)
                self.references.append(Reference(fn, int(toks.next_token())))
            elif t == ">":
                ln = int(toks.next_token())
                toks.next_string(ln)
            elif t == "~":
                schema_lines.append(line[2:])
            elif t == "$":
                isbig = int(toks.next_token())
                if isbig:
                    raise ValueError(f"{self.path}: big-endian binary "
                                     f"ONEcode not supported")
                # data begins right after this line's newline
                self._data_start = self._f.tell()
                break
            elif t in "#@+%.":
                self._parse_count_line(line)
            else:
                # ASCII data line: not a binary file after all
                raise ValueError(f"{self.path}: ASCII ONEcode file; use "
                                 f"onecode.OneReader")
        if self.schema is None and schema_lines:
            text = (f"P {len(self.filetype)} {self.filetype}\n"
                    + "\n".join(schema_lines))
            self.schema = OneSchema.from_text(text)[self.filetype]

    def _parse_count_line(self, line: str):
        t = line[0]
        toks = onecode._Tokens(line)
        toks.next_token()
        if t == "#":
            c = toks.next_token()
            self.counts.setdefault(c, {})["count"] = int(toks.next_token())
        elif t == "@":
            c = toks.next_token()
            self.counts.setdefault(c, {})["max"] = int(toks.next_token())
        elif t == "+":
            c = toks.next_token()
            self.counts.setdefault(c, {})["total"] = int(toks.next_token())
        elif t == "%":
            oc = toks.next_token()
            which = toks.next_token()
            tc = toks.next_token()
            v = int(toks.next_token())
            self.group_stats.setdefault(oc, {}).setdefault(tc, {})[
                "max_count" if which == "#" else "max_total"] = v

    def _read_footer(self):
        f = self._f
        f.seek(-8, 2)
        foot_off = struct.unpack("<q", f.read(8))[0]
        self._foot_off = foot_off
        f.seek(foot_off)
        while True:
            c = f.read(1)
            if not c:
                break
            if c[0] & 0x80:
                t, fields = self._read_binary_line(c[0])
                if t == "&":
                    self.indexes[fields[0]] = fields[1]
                elif t == ";":
                    self.codecs[fields[0]] = VCCodec(
                        fields[1].encode("latin-1"))
            else:
                if c == b"^":
                    break
                if c == b"\n":
                    continue
                line = self._ascii_line(c)
                if line.strip():
                    self._parse_count_line(line)

    def _read_fields(self, spec_fields, use_codec: bool, t: str):
        f = self._f
        fields = []
        list_len = None
        for ft in spec_fields:
            if ft == REAL:
                fields.append(struct.unpack("<d", f.read(8))[0])
            elif ft == CHAR:
                fields.append(f.read(1).decode("latin-1"))
            else:
                v = ltf_read(f)
                fields.append(v)
                if ft in _LIST_TYPES:
                    list_len = v
        # materialize the list in place of its length field
        for fi, ft in enumerate(spec_fields):
            if ft not in _LIST_TYPES:
                continue
            n = fields[fi]
            if ft == STRING_LIST:
                # ASCII " <len> <chars>" encoding even in binary files
                out = []
                for _ in range(n):
                    sl = self._ascii_int()  # consumes the trailing space
                    out.append(f.read(sl).decode("latin-1"))
                fields[fi] = out
                continue
            if n == 0:
                fields[fi] = [] if ft in (INT_LIST, REAL_LIST) else ""
                continue
            if ft == INT_LIST:
                first = ltf_read(f)
                if n == 1:
                    fields[fi] = [first]
                    continue
                used = f.read(1)[0]
                if use_codec:
                    nbits = ltf_read(f)
                    raw = f.read((nbits + 7) >> 3)
                    dec = self.codecs[t].decode(nbits, raw, (n - 1) * used)
                    fields[fi] = _decompact_ints(first, dec, used, n)
                else:
                    raw = f.read((n - 1) * used)
                    fields[fi] = _decompact_ints(first, raw, used, n)
            elif ft == REAL_LIST:
                if use_codec:
                    nbits = ltf_read(f)
                    raw = self.codecs[t].decode(
                        nbits, f.read((nbits + 7) >> 3), 8 * n)
                else:
                    raw = f.read(8 * n)
                fields[fi] = list(struct.unpack(f"<{n}d", raw))
            else:  # STRING or DNA
                spec = self.schema.lines.get(t) if self.schema else None
                is_dna = ft == DNA
                if is_dna:
                    nbits = 2 * n
                    raw = f.read((n + 3) // 4)
                    fields[fi] = dna_decode(raw, n).decode("latin-1")
                elif use_codec:
                    nbits = ltf_read(f)
                    raw = f.read((nbits + 7) >> 3)
                    fields[fi] = self.codecs[t].decode(
                        nbits, raw, n).decode("latin-1")
                else:
                    fields[fi] = f.read(n).decode("latin-1")
                del spec
        return fields

    def _ascii_int(self) -> int:
        f = self._f
        out = []
        while True:
            c = f.read(1)
            if not c or not c.isdigit():
                if not out and c == b" ":
                    continue
                break
            out.append(c)
        return int(b"".join(out))

    def _read_binary_line(self, pack: int):
        code = (pack >> 1) & 0x3F
        use_codec = bool(pack & 1)
        t = _CODE_TO_CHAR.get(code)
        if t is None:
            raise ValueError(f"bad binary line code {code}")
        if t in _HEADER_SPECS:
            spec_fields = _HEADER_SPECS[t]
        else:
            spec = self.schema.lines.get(t)
            if spec is None:
                raise ValueError(f"line type '{t}' not in schema")
            spec_fields = spec.fields
        fields = self._read_fields(spec_fields, use_codec, t)
        return t, fields

    def __iter__(self):
        f = self._f
        end = self._foot_off
        while True:
            if end is not None and f.tell() >= end:
                break
            c = f.read(1)
            if not c:
                break
            if c[0] & 0x80:
                t, fields = self._read_binary_line(c[0])
                if t == "/":
                    continue
                if t == ".":
                    continue
                yield OneLine(t, tuple(fields))
            else:
                if c in (b"\n", b" "):
                    continue
                line = self._ascii_line(c)
                if not line.strip() or line[0] in ".^/":
                    continue
                # mixed ASCII data line
                rdr = onecode.OneReader.__new__(onecode.OneReader)
                rdr.schema = self.schema
                yield rdr._parse_line(line)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_any(path, schema: Optional[OneSchema] = None):
    """Return an iterator-capable reader for ASCII or binary ONEcode
    (the '$' header line marks binary files)."""
    with open(path, "rb") as probe:
        head = probe.read(65536)
    for line in head.split(b"\n"):
        if line.startswith(b"$ "):
            return BinaryReader(path, schema)
        if line[:1].isalpha() and not line.startswith(b"1 ") \
           and not line.startswith(b"2 "):
            break  # data lines reached without '$': ASCII
    try:
        return onecode.OneReader(path, schema)
    except ValueError:
        return BinaryReader(path, schema)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class BinaryWriter:
    """Binary ONEcode writer with trained list codecs (DNAcodec for DNA,
    per-line-type adaptive Huffman for other list types after 100 KB of
    raw training data — the reference's oneWriteLine protocol,
    ONElib.c:2412-2515)."""

    def __init__(self, path, schema: OneSchema, filetype: Optional[str] = None):
        self.path = Path(path)
        self.schema = schema
        self.filetype = filetype or schema.primary
        self.provenance: List[Provenance] = []
        self.references: List[Reference] = []
        self._lines: List[Tuple[str, tuple]] = []
        self._closed = False
        self._vcs: Dict[str, VCEncoder] = {}

    def _vc_for(self, t: str, spec_fields) -> Optional[VCEncoder]:
        """Trainable codec for line type t, or None.  Mirrors the
        reference's eligibility: any list type except STRING_LIST
        (written as ASCII), DNA (fixed DNAcodec) and '/' comments;
        includes the '&' footer index lines (ONElib.c:188-190)."""
        if t == "/" or t == ";":
            return None
        has = any(ft in (INT_LIST, REAL_LIST, STRING)
                  for ft in spec_fields)
        if not has:
            return None
        vc = self._vcs.get(t)
        if vc is None:
            vc = self._vcs[t] = VCEncoder()
        return vc

    add_provenance = onecode.OneWriter.add_provenance
    add_reference = onecode.OneWriter.add_reference
    write = onecode.OneWriter.write
    _counts = onecode.OneWriter._counts

    def close(self):
        if self._closed:
            return
        self._closed = True
        stats, gstats = self._counts()
        f = open(self.path, "wb")

        def a(s):
            f.write(s.encode("latin-1"))

        a(f"1 {len(self.filetype)} {self.filetype} {onecode.MAJOR} "
          f"{onecode.MINOR}")
        for p in self.provenance:
            a(f"\n! 4 {len(p.program)} {p.program} {len(p.version)} "
              f"{p.version} {len(p.command)} {p.command} {len(p.date)} "
              f"{p.date}")
        a("\n.")
        if self.references:
            for r in self.references:
                a(f"\n< {len(r.filename)} {r.filename} {r.count}")
            a("\n.")
        for ln in self.schema.spec_header_lines():
            a("\n" + ln)
        a("\n$ 0")
        f.write(b"\n")
        data_start = f.tell()

        indexes: Dict[str, List[int]] = {}
        for t, fields in self._lines:
            spec = self.schema.lines[t]
            if spec.is_object:
                indexes.setdefault(t, [data_start]).append(f.tell())
            self._write_binary_line(f, t, spec, fields)

        # newline terminating the binary data region (oneFileClose writes it
        # before the footer; sequential readers need it)
        f.write(b"\n")
        # footer: ASCII count lines interleaved with binary '&' index
        # lines, plus ';' serialized-codec lines in oneWriteFooter's
        # order (ONElib.c:2617-2662): per type — counts, '&' index, the
        # '&' codec once it has trained, then the type's own codec
        foot_off = f.tell()
        written_index_codec = False
        for kind, c in self.schema.defn_order:
            if kind == "G" or c not in stats:
                continue
            cnt, mx, tot = stats[c]
            if cnt <= 0:
                continue
            a(f"# {c} {cnt}\n")
            if mx > 0:
                a(f"@ {c} {mx}\n")
            if tot > 0:
                a(f"+ {c} {tot}\n")
            if c in gstats:
                for t2, (mc, mt) in sorted(gstats[c].items()):
                    if mc:
                        a(f"% {c} # {t2} {mc}\n")
                    if mt:
                        a(f"% {c} + {t2} {mt}\n")
            if c in indexes:
                self._write_binary_line(f, "&", None, (c, indexes[c]))
            vca = self._vcs.get("&")
            if vca is not None and vca.trained and not written_index_codec:
                self._write_binary_line(f, ";", None,
                                        ("&", vca.serialize()))
                written_index_codec = True
            vcc = self._vcs.get(c)
            if vcc is not None and vcc.trained:
                self._write_binary_line(f, ";", None,
                                        (c, vcc.serialize()))
        a("^\n")
        f.write(struct.pack("<q", foot_off))
        f.close()

    def _write_binary_line(self, f, t, spec, fields):
        code = _CHAR_TO_CODE[t]
        spec_fields = _HEADER_SPECS[t] if spec is None else spec.fields
        vc = self._vc_for(t, spec_fields)
        use_codec = any(ft == DNA for ft in spec_fields) \
            or (vc is not None and vc.trained)
        f.write(bytes([0x80 | (code << 1) | (1 if use_codec else 0)]))
        # fields (list length in place of list content)
        payloads = []
        for fi, ft in enumerate(spec_fields):
            v = fields[fi]
            if ft == REAL:
                f.write(struct.pack("<d", float(v)))
            elif ft == CHAR:
                f.write(str(v)[:1].encode("latin-1"))
            elif ft == INT:
                f.write(ltf_write(int(v)))
            else:
                f.write(ltf_write(len(v)))
                payloads.append((fi, ft, v))

        def emit_list(payload: bytes):
            """Write one list payload, codec'd once trained; train the
            codec on the raw bytes until then (ONElib.c:2446-2471)."""
            if vc is not None and vc.trained:
                nbits, stream = vc.encode(payload)
                f.write(ltf_write(nbits))
                f.write(stream)
                return
            f.write(payload)
            if vc is not None:
                vc.add(payload)
                if vc.tack > CODEC_TRAINING:
                    vc.create(1)

        for fi, ft, v in payloads:
            n = len(v)
            if n == 0:
                continue
            if ft == INT_LIST:
                vals = [int(x) for x in v]
                f.write(ltf_write(vals[0]))
                if n == 1:
                    continue
                used, diffs = _compact_ints(vals)
                f.write(bytes([used]))
                emit_list(diffs)
            elif ft == REAL_LIST:
                emit_list(struct.pack(f"<{n}d",
                                      *[float(x) for x in v]))
            elif ft == STRING_LIST:
                for s in v:
                    f.write(f" {len(s)} {s}".encode("latin-1"))
            elif ft == DNA:
                s = v.encode("latin-1") if isinstance(v, str) else bytes(v)
                f.write(dna_encode(s))
            else:  # STRING
                s = v.encode("latin-1") if isinstance(v, str) else bytes(v)
                emit_list(s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

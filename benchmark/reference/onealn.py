"""A plain reader of binary ONEcode ``.1aln`` files (ONElib's binary form).

Written for the reference from the format's description in ONElib.c: an
ASCII header (the schema on ``~`` lines) ending in ``$ <isBig>``; binary
data lines, each a pack byte ``0x80 | code << 1 | useCodec`` (codes 0-25
'A'-'Z', 26-51 'a'-'z', 52 ';', 53 '&', 54 '/', 55 '.') and its fields:
integers in the variable-length ``ltf`` code, lists as their length, then
(integer lists) the first value, a byte width and the differences of the
rest in that width, little-endian, the lists of a trained type Huffman
coded; then a footer (count lines, codecs, indices) whose offset is the
file's last eight bytes.

``read_aln(path)`` returns (skeletons, records, counts): the contig
lengths of each embedded genome skeleton, one ``Record`` per ``A`` line,
and the footer's ``#`` counts by line type.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from .records import Record

_CODES = ([chr(ord("A") + i) for i in range(26)]
          + [chr(ord("a") + i) for i in range(26)] + [";", "&", "/", "."])
_FOOTER_FIELDS = {";": ("CHAR", "STRING"), "&": ("CHAR", "INT_LIST"),
                  "/": ("STRING",), ".": ()}


class FormatError(ValueError):
    pass


def _ltf(buf: bytes, i: int) -> Tuple[int, int]:
    u = buf[i]
    if u & 0x40:
        return (u - 256 if u & 0x80 else u & 0x3F), i + 1
    if u & 0x20:
        return ((u & 0x1F) << 8) | buf[i + 1], i + 2
    n = (u & 0x0F) + 1
    v = int.from_bytes(buf[i + 1:i + 1 + n], "little")
    if u & 0x80:
        v -= 1 << (8 * n)
    return v, i + 1 + n


class _Huffman:
    """A serialized list codec: 256 code lengths and codes, an escape;
    decoded through a table of every 16-bit prefix."""

    def __init__(self, blob: bytes):
        if blob[0]:
            raise FormatError("big-endian codec")
        self.esc = int.from_bytes(blob[1:5], "little", signed=True)
        esc_len = int.from_bytes(blob[5:9], "little", signed=True)
        self.lens = [0] * 256
        self.look = bytearray(1 << 16)
        p = 9
        for c in range(256):
            ln = blob[p]
            p += 1
            if ln > 0 or c == self.esc:
                code = int.from_bytes(blob[p:p + 2], "little")
                p += 2
                ln = esc_len if c == self.esc else ln
                if not 0 < ln <= 16:
                    raise FormatError("bad Huffman code length")
                self.lens[c] = ln
                base = code << (16 - ln)
                self.look[base:base + (1 << (16 - ln))] = \
                    bytes([c]) * (1 << (16 - ln))

    def decode(self, nbits: int, data: bytes, out_len: int) -> bytes:
        if data[0] == 0xFF:                      # stored uncompressed
            return bytes(data[1:1 + (nbits >> 3) - 1])
        b = bytearray(data)
        if nbits >= 64:
            b[0], b[7] = b[7], b[0]
        words = nbits // 64
        stream = bytearray()
        for w in range(words):                   # 64-bit words, LSB first
            stream += b[8 * w:8 * w + 8][::-1]
        stream += b[8 * words:]
        total = 8 * len(stream)
        val = int.from_bytes(stream, "big")
        out = bytearray()
        pos = 2                                  # two header bits
        while pos < nbits and len(out) < out_len:
            sh = total - pos - 16
            c = self.look[(val >> sh if sh >= 0 else val << -sh) & 0xFFFF]
            pos += self.lens[c]
            if c == self.esc:
                sh = total - pos - 8
                c = (val >> sh if sh >= 0 else val << -sh) & 0xFF
                pos += 8
            out.append(c)
        return bytes(out)


def _schema(header_lines: List[str]) -> Dict[str, Tuple[str, ...]]:
    types = {}
    for line in header_lines:
        tok = line.split()
        if len(tok) >= 3 and tok[0] in ("D", "O", "G"):
            n = int(tok[2]) if len(tok) > 2 else 0
            fields = tuple(tok[4 + 2 * k] for k in range(n))
            types[tok[1]] = fields
    return types


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.codecs: Dict[str, _Huffman] = {}

    def fields(self, i: int, spec, t: str, codec: bool):
        buf = self.buf
        vals = []
        for ft in spec:
            if ft == "CHAR":
                vals.append(chr(buf[i]))
                i += 1
            elif ft == "REAL":
                vals.append(struct.unpack_from("<d", buf, i)[0])
                i += 8
            else:
                v, i = _ltf(buf, i)
                vals.append(v)
        for k, ft in enumerate(spec):
            if ft == "INT_LIST":
                n = vals[k]
                if n == 0:
                    vals[k] = []
                    continue
                first, i = _ltf(buf, i)
                if n == 1:
                    vals[k] = [first]
                    continue
                width = buf[i]
                i += 1
                if codec:
                    nbits, i = _ltf(buf, i)
                    nb = (nbits + 7) >> 3
                    raw = self.codecs[t].decode(nbits, buf[i:i + nb],
                                                (n - 1) * width)
                    i += nb
                else:
                    raw = buf[i:i + (n - 1) * width]
                    i += (n - 1) * width
                out = [first]
                for j in range(n - 1):
                    out.append(out[-1] + int.from_bytes(
                        raw[j * width:(j + 1) * width], "little",
                        signed=True))
                vals[k] = out
            elif ft == "STRING":
                n = vals[k]
                if codec:
                    nbits, i = _ltf(buf, i)
                    nb = (nbits + 7) >> 3
                    vals[k] = self.codecs[t].decode(nbits, buf[i:i + nb], n)
                    i += nb
                else:
                    vals[k] = bytes(buf[i:i + n])
                    i += n
            elif ft not in ("INT", "CHAR", "REAL"):
                raise FormatError(f"field type {ft} not read here")
        return vals, i


def read_aln(path: str):
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(b"1 "):
        raise FormatError(f"{path}: not a ONEcode file")
    # header
    i = 0
    header = []
    while True:
        j = buf.index(b"\n", i)
        line = buf[i:j].decode("latin-1")
        i = j + 1
        if line.startswith("$"):
            if line.split()[1] != "0":
                raise FormatError("big-endian data")
            break
        if line.startswith("~"):
            header.append(line[1:].strip())
    schema = _schema(header)
    for need in ("A", "D", "T", "X", "C", "R", "t"):
        if need not in schema:
            raise FormatError(f"schema lacks line type {need}")
    foot = struct.unpack_from("<q", buf, len(buf) - 8)[0]
    if not i <= foot < len(buf) - 8:
        raise FormatError("footer offset outside the file")
    rd = _Reader(buf)
    # footer: counts and codecs
    counts: Dict[str, int] = {}
    k = foot
    while k < len(buf) - 8:
        c = buf[k]
        if c & 0x80:
            t = _CODES[(c >> 1) & 0x3F]
            vals, k = rd.fields(k + 1, _FOOTER_FIELDS.get(t, ()), t, False)
            if t == ";":
                rd.codecs[vals[0]] = _Huffman(vals[1])
            continue
        if c == ord("^"):
            break
        j = buf.index(b"\n", k)
        tok = buf[k:j].decode("latin-1").split()
        if tok and tok[0] == "#":
            counts[tok[1]] = int(tok[2])
        k = j + 1
    # data
    skeletons: List[List[int]] = []
    records: List[Record] = []
    seen: Dict[str, int] = {}
    cur = None
    k = i
    while k < foot:
        c = buf[k]
        if c == 10:                              # a line end between lines
            k += 1
            continue
        if not c & 0x80:
            raise FormatError(f"byte {k}: not a binary data line")
        t = _CODES[(c >> 1) & 0x3F]
        spec = _FOOTER_FIELDS.get(t) if t in "/." else schema.get(t)
        if spec is None:
            raise FormatError(f"byte {k}: line type {t!r} not in the schema")
        vals, k = rd.fields(k + 1, spec, t, bool(c & 1))
        seen[t] = seen.get(t, 0) + 1
        if t == "g":
            skeletons.append([])
        elif t == "C":
            skeletons[-1].append(vals[0])
        elif t == "A":
            cur = Record(vals[0], vals[3], False, vals[1], vals[2], vals[4],
                         vals[5], -1, None)
            records.append(cur)
        elif t == "R":
            cur.comp = True
        elif t == "D":
            cur.diffs = vals[0]
        elif t == "T":
            cur.trace = [(None, b) for b in vals[0]]
        elif t == "X":
            if cur.trace is None or len(cur.trace) != len(vals[0]):
                raise FormatError("an X list unlike its T list")
            cur.trace = [(d, b) for d, (_, b) in zip(vals[0], cur.trace)]
    if k != foot:
        raise FormatError("data overruns the footer")
    for t, n in counts.items():
        if seen.get(t, 0) != n and t in "ARDTX":
            raise FormatError(f"footer counts {n} {t} lines, the data {seen.get(t, 0)}")
    return skeletons, records, counts

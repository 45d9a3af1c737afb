# Copied from fastga_tpu/io/onecode.py; imports point at fastga_tpu_torch.
"""ONEcode container: schema-driven structured files (ASCII form).

A clean-room implementation of the ONEcode data framework used by all of the
reference's file types (.1gdb/.1aln/.1ano/.1seq).  Format semantics follow
ONElib.c (reference: header writeHeader ONElib.c:2211-2276, counts
writeCounts ONElib.c:2186, ASCII line emission oneWriteLine ONElib.c:2524+):

ASCII layout::

    1 <len> <filetype> <major> <minor>     file type + version
    2 <len> <subtype>                      optional subtype
    ! 4 <l> prog <l> version <l> command <l> date    provenance (repeatable)
    .                                      spacer
    < <len> <filename> <count>             references (optional)
    ~ O S 1 6 STRING  ...                  schema lines embedded in header
    .
    # <t> <count>                          counts (ascii only)
    @ <t> <max-list-len>
    + <t> <total-list-len>
    % <obj> # <t> <max-per-object> / % <obj> + <t> <max-total-per-object>
    .
    <data lines: type char + space-separated fields>

Field encodings on data lines: INT/REAL plain, CHAR plain, STRING/DNA as
``<len> <chars>``, INT_LIST/REAL_LIST as ``<len> <v>...``, STRING_LIST as
``<len> (<slen> <str>)...``.

Binary ONEcode (with trained codecs) is handled in onecode_binary.py.
"""

from __future__ import annotations

import io as _io
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

MAJOR, MINOR = 2, 1  # ONElib.c:55-56

INT = "INT"
REAL = "REAL"
CHAR = "CHAR"
STRING = "STRING"
DNA = "DNA"
INT_LIST = "INT_LIST"
REAL_LIST = "REAL_LIST"
STRING_LIST = "STRING_LIST"

_LIST_TYPES = {STRING, DNA, INT_LIST, REAL_LIST, STRING_LIST}


@dataclass
class LineSpec:
    char: str
    is_object: bool
    fields: Tuple[str, ...]
    comment: str = ""


@dataclass
class OneSchema:
    """Schema for one primary file type: line definitions + group relations."""

    primary: str
    lines: dict = field(default_factory=dict)  # char -> LineSpec
    groups: dict = field(default_factory=dict)  # group char -> grouped char
    defn_order: list = field(default_factory=list)  # (kind, char) in defn order

    @staticmethod
    def from_text(text: str) -> "dict[str, OneSchema]":
        """Parse a schema text (same grammar as oneSchemaCreateFromText).

        Returns {primary_name: OneSchema} for each P section.
        """
        schemas = {}
        cur: Optional[OneSchema] = None
        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith("."):
                continue
            toks = line.split()
            kind = toks[0]
            if kind == "1":  # header line of a schema file: 1 <l> def <maj> <min>
                continue
            if kind == "P":
                name = toks[2]
                cur = OneSchema(primary=name)
                schemas[name] = cur
            elif kind == "G":
                # 'G <char>' right after an O line: that object groups <char>
                # objects.  ONElib keeps these in definition order and emits
                # them as '~ G <char> 0' header lines (writeInfoSpec).
                if cur is None:
                    continue
                gchar = toks[1]
                cur.defn_order.append(("G", gchar))
                last_obj = next(
                    (c for k, c in reversed(cur.defn_order) if k == "O"),
                    None)
                if last_obj is not None:
                    cur.groups[last_obj] = gchar
            elif kind in ("O", "D"):
                c = toks[1]
                nf = int(toks[2])
                fields = []
                i = 3
                for _ in range(nf):
                    flen = int(toks[i])
                    ftype = toks[i + 1]
                    assert len(ftype) == flen, f"bad schema field {toks[i:i+2]}"
                    fields.append(ftype)
                    i += 2
                comment = " ".join(toks[i:])
                cur.lines[c] = LineSpec(c, kind == "O", tuple(fields), comment)
                cur.defn_order.append((kind, c))
        for s in schemas.values():
            s._build_contains()
        return schemas

    def _build_contains(self):
        """Containment per ONElib initialiseStats (ONElib.c:505-535): D lines
        belong to the preceding O object, G relations declare grouped
        objects, then transitive closure through contained objects."""
        self.contains = {}
        cur_obj = None
        for kind, c in self.defn_order:
            if kind == "O":
                cur_obj = c
                self.contains.setdefault(c, set())
            elif cur_obj is not None:
                self.contains[cur_obj].add(c)
        changed = True
        while changed:
            changed = False
            for o, kids in self.contains.items():
                for k in list(kids):
                    for sub in self.contains.get(k, ()):
                        if sub not in kids:
                            kids.add(sub)
                            changed = True

    def has_list(self, c: str) -> bool:
        spec = self.lines.get(c)
        return bool(spec) and any(f in _LIST_TYPES for f in spec.fields)

    def spec_header_lines(self) -> List[str]:
        """Schema as '~' header lines (writeInfoSpec ONElib.c:455-472)."""
        out = []
        for kind, c in self.defn_order:
            if kind == "G":
                out.append(f"~ G {c} 0")
            else:
                spec = self.lines[c]
                fstr = " ".join(f"{len(t)} {t}" for t in spec.fields)
                kd = "O" if spec.is_object else "D"
                out.append(f"~ {kd} {c} {len(spec.fields)}" + (f" {fstr}" if fstr else ""))
        return out


@dataclass
class Provenance:
    program: str
    version: str
    command: str
    date: str


@dataclass
class Reference:
    filename: str
    count: int


def _fmt_real(x: float) -> str:
    return f"{x:f}"


class OneWriter:
    """Write a ONEcode file in ASCII.  Lines are buffered so that accurate
    counts can be emitted in the header at close() (ONElib emits counts in
    the footer for binary, in the header for ASCII)."""

    def __init__(self, path, schema: OneSchema, filetype: Optional[str] = None):
        self.path = Path(path)
        self.schema = schema
        self.filetype = filetype or schema.primary
        self.provenance: List[Provenance] = []
        self.references: List[Reference] = []
        self._lines: List[Tuple[str, tuple]] = []
        self._closed = False

    def add_provenance(self, program: str, version: str, command: str,
                       date: Optional[str] = None):
        if date is None:
            date = time.strftime("%Y-%m-%d_%H:%M:%S")
        self.provenance.append(Provenance(program, version, command, date))

    def add_reference(self, filename: str, count: int):
        self.references.append(Reference(filename, count))

    def write(self, type_char: str, *fields):
        spec = self.schema.lines.get(type_char)
        if spec is None:
            raise ValueError(f"line type '{type_char}' not in schema "
                             f"{self.schema.primary}")
        if len(fields) != len(spec.fields):
            raise ValueError(
                f"line '{type_char}' expects {len(spec.fields)} fields, "
                f"got {len(fields)}")
        self._lines.append((type_char, fields))

    # -- serialization ------------------------------------------------------

    def _field_str(self, ftype: str, v) -> str:
        if ftype == INT:
            return str(int(v))
        if ftype == REAL:
            return _fmt_real(float(v))
        if ftype == CHAR:
            return str(v)
        if ftype in (STRING, DNA):
            if isinstance(v, bytes):
                v = v.decode("ascii")
            return f"{len(v)} {v}"
        if ftype == INT_LIST:
            return f"{len(v)} " + " ".join(str(int(x)) for x in v) if len(v) \
                else "0"
        if ftype == REAL_LIST:
            return f"{len(v)} " + " ".join(_fmt_real(float(x)) for x in v) \
                if len(v) else "0"
        if ftype == STRING_LIST:
            return f"{len(v)} " + " ".join(f"{len(s)} {s}" for s in v) \
                if len(v) else "0"
        raise AssertionError(ftype)

    def _counts(self):
        """Per-type (count, max, total) plus per-object '%' stats, computed
        with ONElib's open-object stack (oneWriteLine ONElib.c:2368-2371:
        writing a line a stacked object doesn't contain pops it, updating
        the per-instance maxima recorded by startObject/endObject)."""
        stats = {}
        contains = getattr(self.schema, "contains", {})
        objstats = {o: {t: [0, 0] for t in sorted(kids)}
                    for o, kids in contains.items()}
        stack: List[tuple] = []   # (obj char, {type: count at open},
                                  #            {type: total at open})

        def end_object():
            o, c0, t0 = stack.pop()
            for t, (mc, mt) in objstats[o].items():
                st = stats.get(t)
                cnt = (st[0] if st else 0) - c0[t]
                tot = (st[2] if st else 0) - t0[t]
                if cnt > mc:
                    objstats[o][t][0] = cnt
                if tot > mt:
                    objstats[o][t][1] = tot

        for t, fields in self._lines:
            spec = self.schema.lines[t]
            while stack and t not in contains.get(stack[-1][0], ()):
                end_object()
            st = stats.setdefault(t, [0, 0, 0])
            st[0] += 1
            for ftype, v in zip(spec.fields, fields):
                if ftype in _LIST_TYPES:
                    if ftype == STRING_LIST:
                        ll = sum(len(s) for s in v)
                    else:
                        ll = len(v)
                    st[2] += ll
                    st[1] = max(st[1], ll)
            if spec.is_object and t in objstats:
                c0 = {k: stats.get(k, (0, 0, 0))[0] for k in objstats[t]}
                t0 = {k: stats.get(k, (0, 0, 0))[2] for k in objstats[t]}
                stack.append((t, c0, t0))
        while stack:
            end_object()
        return stats, objstats

    def close(self):
        if self._closed:
            return
        self._closed = True
        stats, gstats = self._counts()
        with open(self.path, "w") as f:
            f.write(f"1 {len(self.filetype)} {self.filetype} {MAJOR} {MINOR}")
            for p in self.provenance:
                f.write(f"\n! 4 {len(p.program)} {p.program} "
                        f"{len(p.version)} {p.version} "
                        f"{len(p.command)} {p.command} {len(p.date)} {p.date}")
            f.write("\n.")
            if self.references:
                for r in self.references:
                    f.write(f"\n< {len(r.filename)} {r.filename} {r.count}")
                f.write("\n.")
            for ln in self.schema.spec_header_lines():
                f.write("\n" + ln)
            f.write("\n.\n")
            for kind, c in self.schema.defn_order:
                if kind == "G" or c not in stats:
                    continue
                cnt, mx, tot = stats[c]
                if cnt > 0:
                    f.write(f"# {c} {cnt}\n")
                    if mx > 0:
                        f.write(f"@ {c} {mx}\n")
                    if tot > 0:
                        f.write(f"+ {c} {tot}\n")
                    if c in gstats:
                        for t, (mc, mt) in sorted(gstats[c].items()):
                            if mc:
                                f.write(f"% {c} # {t} {mc}\n")
                            if mt:
                                f.write(f"% {c} + {t} {mt}\n")
            f.write(".")  # spacer ending header (incomplete line convention)
            for t, fields in self._lines:
                spec = self.schema.lines[t]
                parts = [t]
                for ftype, v in zip(spec.fields, fields):
                    parts.append(self._field_str(ftype, v))
                f.write("\n" + " ".join(parts))
            f.write("\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class OneLine:
    type: str
    fields: tuple

    def __getitem__(self, i):
        return self.fields[i]


class _Tokens:
    """Whitespace tokenizer that honors ONEcode length-prefixed strings."""

    __slots__ = ("s", "i", "n")

    def __init__(self, s: str):
        self.s = s
        self.i = 0
        self.n = len(s)

    def next_token(self) -> str:
        s, i, n = self.s, self.i, self.n
        while i < n and s[i] == " ":
            i += 1
        j = i
        while j < n and s[j] != " ":
            j += 1
        self.i = j
        return s[i:j]

    def next_string(self, length: int) -> str:
        # exactly one space then `length` raw chars (may contain spaces)
        self.i += 1
        out = self.s[self.i : self.i + length]
        self.i += length
        return out

    def rest(self) -> str:
        return self.s[self.i:]


class OneReader:
    """Read a ONEcode ASCII file.  Parses header (type, provenance,
    references, embedded schema, counts) then yields data lines."""

    def __init__(self, path, schema: Optional[OneSchema] = None):
        self.path = Path(path)
        self._f = open(self.path, "r")
        self.filetype = None
        self.subtype = None
        self.provenance: List[Provenance] = []
        self.references: List[Reference] = []
        self.counts: dict = {}     # type -> {"count","max","total"}
        self.group_stats: dict = {}
        self._embedded_schema_text: List[str] = []
        self.schema = schema
        self._pending: Optional[str] = None
        self._read_header()

    def _read_header(self):
        first = self._f.readline()
        if not first:
            raise ValueError(f"{self.path}: empty file")
        if first[:1] == "1" and first[1:2] in (" ", "\n"):
            toks = _Tokens(first.rstrip("\n"))
            toks.next_token()
            tl = int(toks.next_token())
            self.filetype = toks.next_string(tl)
            self.major = int(toks.next_token())
            self.minor = int(toks.next_token())
        else:
            raise ValueError(f"{self.path}: not a ONEcode ASCII file "
                             f"(binary ONEcode not handled by OneReader; "
                             f"use onecode_binary)")
        schema_lines = []
        while True:
            pos_line = self._f.readline()
            if not pos_line:
                self._pending = None
                break
            line = pos_line.rstrip("\n")
            if not line:
                continue
            t = line[0]
            toks = _Tokens(line)
            toks.next_token()
            if t == "2":
                sl = int(toks.next_token())
                self.subtype = toks.next_string(sl)
            elif t == "!":
                toks.next_token()  # list length 4
                vals = []
                for _ in range(4):
                    ln = int(toks.next_token())
                    vals.append(toks.next_string(ln))
                self.provenance.append(Provenance(*vals))
            elif t == "<":
                ln = int(toks.next_token())
                fn = toks.next_string(ln)
                cnt = int(toks.next_token())
                self.references.append(Reference(fn, cnt))
            elif t == ">":
                ln = int(toks.next_token())
                toks.next_string(ln)
            elif t == "~":
                schema_lines.append(line[2:])
            elif t == "#":
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
            elif t == ".":
                continue
            elif t == "$":
                raise ValueError(f"{self.path}: binary ONEcode; "
                                 f"use onecode_binary.BinaryReader")
            else:
                # first data line
                self._pending = line
                break
        if self.schema is None and schema_lines:
            text = (f"P {len(self.filetype)} {self.filetype}\n"
                    + "\n".join(schema_lines))
            self.schema = OneSchema.from_text(text)[self.filetype]

    def _parse_line(self, line: str) -> OneLine:
        t = line[0]
        spec = self.schema.lines.get(t) if self.schema else None
        toks = _Tokens(line)
        toks.next_token()
        if spec is None:
            return OneLine(t, (toks.rest(),))
        fields = []
        for ftype in spec.fields:
            if ftype == INT:
                fields.append(int(toks.next_token()))
            elif ftype == REAL:
                fields.append(float(toks.next_token()))
            elif ftype == CHAR:
                fields.append(toks.next_token())
            elif ftype in (STRING, DNA):
                ln = int(toks.next_token())
                fields.append(toks.next_string(ln))
            elif ftype == INT_LIST:
                ln = int(toks.next_token())
                fields.append([int(toks.next_token()) for _ in range(ln)])
            elif ftype == REAL_LIST:
                ln = int(toks.next_token())
                fields.append([float(toks.next_token()) for _ in range(ln)])
            elif ftype == STRING_LIST:
                ln = int(toks.next_token())
                out = []
                for _ in range(ln):
                    sl = int(toks.next_token())
                    out.append(toks.next_string(sl))
                fields.append(out)
        return OneLine(t, tuple(fields))

    def __iter__(self) -> Iterator[OneLine]:
        if self._pending is not None:
            line = self._pending
            self._pending = None
            if line and line[0] != ".":
                yield self._parse_line(line)
        for raw in self._f:
            line = raw.rstrip("\n")
            if not line or line[0] in (".", "/"):
                continue
            yield self._parse_line(line)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_all(path, schema: Optional[OneSchema] = None) -> Tuple[OneReader, List[OneLine]]:
    """Convenience: open, read all data lines, close. Returns (reader, lines)."""
    r = OneReader(path, schema)
    lines = list(r)
    r.close()
    return r, lines

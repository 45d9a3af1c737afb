"""A plain PAF reader for FastGA's default PAF lines (ALNtoPAF's base
mode): query = genome A, target = genome B, and the tags ``dv:f`` and
``df:i`` (the alignment's differences).

``read_paf(path, names_a, len_a, names_b, len_b)`` returns (records,
malformed): one ``Record`` a line, B coordinates turned to B's reverse
complement for a ``-`` line as in a .1aln file, and the count of lines
whose fields contradict the genomes or each other (a name or length that
is not the genome's, a coordinate outside its sequence, a match count or
block length other than the spans and differences give)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from .records import Record


def read_paf(path: str, names_a: List[str], len_a: List[int],
             names_b: List[str], len_b: List[int]
             ) -> Tuple[List[Record], int]:
    ia: Dict[str, int] = {n: k for k, n in enumerate(names_a)}
    ib: Dict[str, int] = {n: k for k, n in enumerate(names_b)}
    recs: List[Record] = []
    bad = 0
    with open(path) as f:
        for line in f:
            col = line.rstrip("\n").split("\t")
            try:
                qn, ql, qs, qe, strand, tn, tl, ts, te, iid, blk = (
                    col[0], int(col[1]), int(col[2]), int(col[3]), col[4],
                    col[5], int(col[6]), int(col[7]), int(col[8]),
                    int(col[9]), int(col[10]))
                tags = dict(t.split(":", 1) for t in col[12:])
                diffs = int(tags["df"].split(":", 1)[1])
            except (ValueError, IndexError, KeyError):
                bad += 1
                continue
            a, b = ia.get(qn), ib.get(tn)
            if (a is None or b is None or ql != len_a[a] or tl != len_b[b]
                    or strand not in "+-" or not 0 <= qs < qe <= ql
                    or not 0 <= ts < te <= tl):
                bad += 1
                continue
            span = (qe - qs) + (te - ts)
            if iid != (span - diffs) // 2 or blk != span // 2:
                bad += 1
            comp = strand == "-"
            bb, be = (tl - te, tl - ts) if comp else (ts, te)
            recs.append(Record(a, b, comp, qs, qe, bb, be, diffs, None))
    return recs, bad

# Copied from fastga_tpu/cli/paftopsl.py; imports point at fastga_tpu_torch.
"""paftopsl — PAF with CIGARs -> PSL (PAFtoPSL.c surface).

    python -m fastga_tpu_torch.cli.paftopsl [-T<int(8)>] [-C<str(cg:Z:)>]
        <alignments>[.paf]

Writes PSL to stdout.  Block decomposition per
cigar2psl (PAFtoPSL.c:72-230): M/=/X extend blocks, I/D split them;
leading/trailing indels are trimmed into the q/t start/end.
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common

USAGE = "[-T<int(8)>] [-C<str(cg:Z:)>] <alignments:path>[.paf]"


def cigar2psl(cigar: str, qstart, qend, tstart, tend, qsize, strand,
              matches):
    qni = qbi = tni = tbi = 0
    qpos = tpos = 0
    insl = insr = 0
    lens = 0
    sizes, startq, startt = [], [], []
    p = ""
    i = 0
    n = len(cigar)
    clen = 0
    while i < n:
        clen = 0
        while i < n and cigar[i].isdigit():
            clen = 10 * clen + int(cigar[i])
            i += 1
        if clen == 0:
            raise ValueError("CIGAR operator length is zero")
        op = cigar[i]
        i += 1
        if op in "MX=":
            qpos += clen
            tpos += clen
            lens += clen
        elif op == "I":
            if p == "":
                insl = clen
            else:
                sizes.append(lens)
                startq.append(qpos - lens)
                startt.append(tpos - lens)
                lens = 0
            qni += 1
            qbi += clen
            qpos += clen
        elif op == "D":
            if p == "":
                insl = -clen
            else:
                sizes.append(lens)
                startq.append(qpos - lens)
                startt.append(tpos - lens)
                lens = 0
            tni += 1
            tbi += clen
            tpos += clen
        else:
            raise ValueError(f"Invalid CIGAR operator '{op}'")
        p = op
    if p == "I":
        insr = clen
    elif p == "D":
        insr = -clen
    else:
        sizes.append(lens)
        startq.append(qpos - lens)
        startt.append(tpos - lens)

    if qpos != qend - qstart:
        raise ValueError("CIGAR length does not match alignment length "
                         "(query)")
    if tpos != tend - tstart:
        raise ValueError("CIGAR length does not match alignment length "
                         "(target)")

    if insl > 0:
        qni -= 1
        qbi -= insl
        qstart += insl
    elif insl < 0:
        tni -= 1
        tbi += insl
        tstart -= insl
    if insr > 0:
        qni -= 1
        qbi -= insr
        qend -= insr
    elif insr < 0:
        tni -= 1
        tbi += insr
        tend += insr

    startt = [s + tstart for s in startt]
    if strand:
        startq = [qsize - qend + s for s in startq]
    else:
        startq = [s + qstart for s in startq]

    mism = (qend - qstart) - qbi - matches
    if mism < 0:
        raise ValueError("negative misMatches")
    ncount = sum(sizes) - matches - mism
    if ncount < 0:
        raise ValueError("negative nCount")
    return dict(matches=matches, mism=mism, ncount=ncount, qni=qni,
                qbi=qbi, tni=tni, tbi=tbi, qstart=qstart, qend=qend,
                tstart=tstart, tend=tend, sizes=sizes, startq=startq,
                startt=startt)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="", opts="T", str_opts="C")
    if len(pos) != 1:
        raise _common.ArgError("paftopsl", "expects one .paf", USAGE)
    tag = (opts.get("C") or "cg:Z:")[:5]
    paf = Path(pos[0])
    if not paf.name.endswith(".paf"):
        q = Path(str(paf) + ".paf")
        paf = q if q.exists() else paf
    out = sys.stdout

    for raw in open(paf):
        fld = raw.split()
        if not fld:
            continue
        if len(fld) < 11:
            raise _common.ArgError("paftopsl",
                                   "Line of paf has fewer than 11 fields")
        cg = next((f[5:] for f in fld[11:] if f.startswith(tag)), None)
        if cg is None:
            raise _common.ArgError("paftopsl",
                                   "PAF line is missing a CIGAR string")
        strand = 0 if fld[4] == "+" else 1
        try:
            r = cigar2psl(cg, int(fld[2]), int(fld[3]), int(fld[7]),
                          int(fld[8]), int(fld[1]), strand, int(fld[9]))
        except ValueError as e:
            sys.stderr.write(f"paftopsl: PAF record parsing error: "
                             f"{e}: {raw}")
            continue
        out.write(f"{r['matches']}\t{r['mism']}\t0\t{r['ncount']}\t"
                  f"{r['qni']}\t{r['qbi']}\t{r['tni']}\t{r['tbi']}\t"
                  f"{'-' if strand else '+'}\t{fld[0]}\t{fld[1]}\t"
                  f"{r['qstart']}\t{r['qend']}\t{fld[5]}\t{fld[6]}\t"
                  f"{r['tstart']}\t{r['tend']}\t{len(r['sizes'])}\t"
                  + "".join(f"{s}," for s in r["sizes"]) + "\t"
                  + "".join(f"{s}," for s in r["startq"]) + "\t"
                  + "".join(f"{s}," for s in r["startt"]) + "\n")
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)

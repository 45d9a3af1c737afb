"""fastga — the aligner CLI (reference FastGA.c usage surface).

Port of fastga_tpu/cli/fastga.py: the same usage, flags, defaults and
output, on the card (``main(argv, device="cpu")`` runs the kernels' plain
versions instead; without a card and without that argument it exits 1).

    python -m fastga_tpu_torch.cli.fastga [-vkMS] [-L:<log:path>] [-T<int(8)>]
        [-P<dir($TMPDIR)>] [<format(-paf)>]
        [-f<int(10)>] [-c<int(85)>] [-s<int(1000)>] [-l<int(100)>]
        [-i<float(.7)>]
        <source1>[<precursor>] (#[<mask>[.1ano]])*
        [ <source2>[<precursor>] (#[<mask>[.1ano]])* ]

    <format> = -paf[mxsS]* | -psl | -1:<align:path>[.1aln]

Defaults mirror FastGA.c:4444-4637: -f10 -s1000 -c85 -l100 -i.7 -T8;
output is PAF on stdout unless -1 requests a .1aln or -psl a PSL stream.
`#<mask>` arguments soft-mask the preceding genome (forwarded to the
index build like the reference forwards them to GIXmake); -M uses the
genomes' implicit case masks.  Precursor GDB/GIX artifacts are built in
memory (persisted only with -k).  -P is accepted for compatibility (this
implementation streams in memory and needs no sort scratch directory).
-E selects the wave engine: ``torch`` (the default, the card's kernels) or
``ref`` (the exact scalar engine on the host).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from . import _common
from .._version import VERSION
from ..io import alncode, paf, psl
from ..models import aligner
from ..utils import dna, prof

USAGE = ("[-vkMS] [-L:<log:path>] [-T<int(8)>] [-P<dir>] "
         "[<format(-paf)>] [-f<int(10)>] [-c<int(85)>] [-s<int(1000)>] "
         "[-l<int(100)>] [-i<float(.7)>] "
         "<source1>[<precursor>] (#<mask>)* [<source2> (#<mask>)*]\n"
         "         <format> = -paf[mxsS]* | -psl | -1:<align:path>[.1aln]")


def main(argv=None, device=None) -> int:
    with prof.job():
        return _main(argv, device)


def _main(argv, device):
    argv = sys.argv[1:] if argv is None else argv

    # pre-pass: multi-char format options, -L:, and #mask arguments
    # (masks attach to the most recent source seen, FastGA.c:4568-4575)
    out_type = "paf"        # paf | psl | one
    paf_m = paf_x = paf_s = paf_l = False
    log_path = None
    rest = []
    masks = [[], []]
    nsrc = 0
    for a in argv:
        if a.startswith("-paf"):
            out_type = "paf"
            for c in a[4:]:
                if c == "m":
                    paf_m = True
                elif c == "x":
                    paf_x = True
                elif c == "s":
                    paf_s = True
                elif c == "S":
                    paf_l = True
                else:
                    raise _common.ArgError(
                        "fastga", f"do not recognize option {a}", USAGE)
        elif a == "-psl":
            out_type = "psl"
        elif a.startswith("-L"):
            if not a.startswith("-L:"):
                raise _common.ArgError(
                    "fastga", "option -L must be followed by :<filename>",
                    USAGE)
            log_path = a[3:]
        elif a.startswith("#"):
            if nsrc == 0:
                raise _common.ArgError(
                    "fastga", "#mask before any source argument", USAGE)
            masks[min(nsrc, 2) - 1].append(a[1:])
        else:
            if not a.startswith("-"):
                nsrc += 1
            rest.append(a)

    opts, pos = _common.parse_args(rest, flags="vkMS",
                                   opts="Tfsclip", str_opts="1PE")
    if not 1 <= len(pos) <= 2:
        raise _common.ArgError("fastga", "expects 1 or 2 source arguments",
                               USAGE)
    if paf_m and paf_x:
        raise _common.ArgError(
            "fastga", "only one of -paf[m] or -paf[x] can be set", USAGE)
    if paf_s and paf_l:
        raise _common.ArgError(
            "fastga", "only one of -paf[s] or -paf[S] can be set", USAGE)

    verbose = opts["v"]
    keep = opts["k"]
    nthreads = _common.opt_int(opts, "T", 8)
    freq = _common.opt_int(opts, "f", 10)
    chain_break = 2 * _common.opt_int(opts, "s", 1000)
    chain_min = 2 * _common.opt_int(opts, "c", 85)
    align_min = _common.opt_int(opts, "l", 100)
    ident = _common.opt_float(opts, "i", 0.7)
    if not 0.55 <= ident < 1.0:
        raise _common.ArgError(
            "fastga",
            "'-i' minimum alignment similarity must be in [0.55,1.0)",
            USAGE)
    one_name = opts.get("1") or None
    if one_name:
        out_type = "one"
    soft_mask = opts["M"] or bool(masks[0]) or bool(masks[1])
    engine = opts.get("E") or "torch"   # -Eref selects the exact host engine
    if engine not in ("torch", "ref"):
        raise _common.ArgError(
            "fastga", f"-E takes torch or ref, not '{engine}'", USAGE)
    try:
        dev = aligner.resolve_device(device)
    except RuntimeError as e:
        raise _common.ArgError("fastga", str(e))

    log = open(log_path, "a") if log_path else None
    cmd = "fastga " + " ".join(argv)
    if log:
        log.write(f"\n{cmd}\n")

    t0 = time.time()
    timer = prof.PhaseTimer(
        out=[sys.stderr if verbose else None, log]) if (verbose or log) \
        else None
    lazy = engine == "torch" and not soft_mask
    gdb1, t1 = _common.resolve_genome(
        pos[0], nthreads, keep, verbose, mask_files=masks[0],
        soft_mask=soft_mask, lazy=lazy, device=dev)
    if len(pos) == 2:
        gdb2, t2 = _common.resolve_genome(
            pos[1], nthreads, keep, verbose, mask_files=masks[1],
            soft_mask=soft_mask, lazy=lazy, device=dev)
    else:
        gdb2, t2 = gdb1, t1   # self-comparison (FastGA A)
    if timer:
        timer.phase("genome/index resolution")

    params = aligner.FastGAParams(
        freq=freq, chain_break=chain_break, chain_min=chain_min,
        align_min=align_min, align_rate=1.0 - ident,
        soft_mask=soft_mask)

    ovls, stats = aligner.align_genomes(
        gdb1, gdb2, t1, t2, params, engine=engine, device=dev,
        verbose=verbose, symmetric=bool(opts.get("S")))
    if timer:
        timer.phase("seed merge + alignment search")
    stat_text = (
        f"\n  Total seeds = {stats['nseeds']}, "
        f"ave. len = {stats['seed_len_avg']:.1f}\n"
        f"  Total hits = {stats['nhits']}, {stats['nlas']} aln's, "
        f"{stats['nlive']} non-redundant aln's\n"
        f"  Wall: {time.time()-t0:.1f}s\n")
    if verbose:
        sys.stderr.write(stat_text)
    if log:
        log.write(stat_text)
        log.close()

    with prof.span("io.write"):
        prof.count("io.records", len(ovls))
        if out_type == "one":
            out = (one_name if one_name.endswith(".1aln")
                   else one_name + ".1aln")
            selfcmp = len(pos) == 1
            w = alncode.AlnWriter(out, params.tspace,
                                  str(Path(pos[0]).resolve()),
                                  None if selfcmp
                                  else str(Path(pos[1]).resolve()),
                                  str(Path.cwd()), command=cmd)
            w.write_skeleton(gdb1)
            if not selfcmp:
                w.write_skeleton(gdb2)
            for o in ovls:
                w.write_overlap(o)
            w.close()
            return 0

        # sequence caches for exact-trace emission (PAF cigar/cs, PSL)
        acache, bcache = {}, {}

        def get_a(c):
            if c not in acache:
                acache.clear()
                acache[c] = gdb1.get_contig(c)
            return acache[c]

        def get_b(c, comp):
            key = (c, comp)
            if key not in bcache:
                bcache.clear()
                s = gdb2.get_contig(c)
                bcache[key] = dna.revcomp(s) if comp else s
            return bcache[key]

        if out_type == "psl":
            psl.write_psl(ovls, gdb1, gdb2, get_a, get_b, params.tspace,
                          sys.stdout)
        elif paf_m or paf_x or paf_s or paf_l:
            for o in ovls:
                sys.stdout.write(paf.paf_line_exact(
                    o, gdb1, gdb2, get_a(o.aread), get_b(o.bread, o.bcomp),
                    params.tspace, cigar_m=paf_m, cigar_x=paf_x,
                    cs=paf_l, cs_short=paf_s) + "\n")
        else:
            paf.write_paf(ovls, gdb1, gdb2, sys.stdout)
        return 0


if __name__ == "__main__":
    _common.cli_exit(main)

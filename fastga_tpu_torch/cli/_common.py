# Port of fastga_tpu/cli/_common.py; imports point at fastga_tpu_torch.
"""CLI helpers: reference-style option parsing and source-type inference.

The reference uses single-dash glued options (-T8, -f10, -1:name, flags
combinable; gene_core.h ARG_* macros) and infers input types from extensions
with probing (Get_GDB_Paths GDB.c:159, FastGA.c:4657-4737).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..ops.constants import KMER
from ..utils import prof

FASTA_EXTS = (".fa", ".fasta", ".fna", ".fa.gz", ".fasta.gz", ".fna.gz")


class ArgError(SystemExit):
    def __init__(self, prog, msg, usage=""):
        sys.stderr.write(f"{prog}: {msg}\n")
        if usage:
            sys.stderr.write(f"Usage: {prog} {usage}\n")
        super().__init__(1)


def parse_args(argv: List[str], flags: str = "", opts: str = "",
               str_opts: str = "") -> Tuple[Dict, List[str]]:
    """Parse reference-style args.

    ``flags``: combinable boolean letters; ``opts``: letters taking a glued
    numeric value (-T8); ``str_opts``: letters taking a glued string value
    (-P/tmp, -1:name).  Returns (options dict, positional args).
    """
    out: Dict = {f: False for f in flags}
    pos: List[str] = []
    for a in argv:
        if a.startswith("-") and len(a) > 1 and not _is_number(a):
            c = a[1]
            if c in str_opts:
                v = a[2:]
                if v.startswith(":"):
                    v = v[1:]
                out[c] = v
            elif c in opts:
                try:
                    v = a[2:]
                    out[c] = float(v) if ("." in v or "e" in v) else int(v)
                except ValueError:
                    raise ArgError("", f"option -{c} requires a numeric "
                                   f"value, got '{a[2:]}'")
            elif all(ch in flags for ch in a[1:]):
                for ch in a[1:]:
                    out[ch] = True
            else:
                raise ArgError("", f"unknown option {a}")
        else:
            pos.append(a)
    return out, pos


def opt_int(opts: Dict, key: str, default: int) -> int:
    """Numeric option with default; unlike `opts.get(k) or d` an explicit
    0 is honored."""
    v = opts.get(key)
    return default if v is None or v is False else int(v)


def opt_float(opts: Dict, key: str, default: float) -> float:
    v = opts.get(key)
    return default if v is None or v is False else float(v)


def _is_number(a: str) -> bool:
    try:
        float(a)
        return True
    except ValueError:
        return False


def infer_source(path: str) -> Tuple[str, Path]:
    """Classify an input as ('gdb'|'gix'|'fasta', resolved path).

    Probes extensions the way the reference does: explicit extension wins,
    else try .gix, .1gdb, then FASTA variants.
    """
    p = Path(path)
    name = p.name
    if name.endswith(".gix"):
        return "gix", p
    if name.endswith(".1gdb") or name.endswith(".gdb"):
        return "gdb", p
    for ext in FASTA_EXTS:
        if name.endswith(ext):
            return "fasta", p
    # probe
    for ext, t in [(".gix", "gix"), (".1gdb", "gdb")] + \
                  [(e, "fasta") for e in FASTA_EXTS]:
        q = p.parent / (name + ext)
        if q.exists():
            return t, q
    if p.exists():
        return "fasta", p
    raise ArgError("", f"cannot find {path} (tried .gix/.1gdb/FASTA variants)")


def resolve_genome(path: str, nthreads: int = 8, keep: bool = False,
                   verbose: bool = False, mask_files=None,
                   soft_mask: bool = False, lazy: bool = False,
                   device=None):
    """Input -> (GDB, GixTable-or-None), building whatever is missing.

    Mirrors FastGA's precursor resolution (FastGA.c:4646-4775): a .gix input
    loads the index from disk; a .1gdb builds the index in memory; a FASTA
    builds both.  With ``keep`` the built artifacts are persisted next to
    the source like -k.

    ``mask_files``: FastGA `#<mask>` arguments for this genome — .1ano
    paths whose union becomes the index's soft-mask bytes (the reference
    forwards them to GIXmake, FastGA.c:4739-4775).  ``soft_mask`` (-M)
    pulls the implicit `.1ano` even without explicit # args.  With
    ``lazy`` and no masking in play, FASTA/GDB inputs return table=None
    so the caller's device pipeline can build the index on the card.  An
    index built here, with its masks, comes from ``build_index``.
    """
    from ..io import ano as anom
    from ..io import gdb as gdbm
    from ..io import gix as gixm

    with prof.span("cli.resolve_genome"):
        t, p = infer_source(path)
        root = _root(p)
        if t == "gix":
            gdb = gdbm.read_gdb(root)
            table = gixm.read_gix(root)
            return gdb, table
        if t == "gdb":
            gdb = gdbm.read_gdb(root)
            masks = None
        else:
            if verbose:
                sys.stderr.write(f"  Creating genome data base (GDB) "
                                 f"{root}.1gdb"
                                 f"{' (in memory)' if not keep else ''}\n")
            gdb, masks = gdbm.create_gdb(p, target=root if keep else None)
            if keep and masks:
                # FAtoGDB persists the implicit case-mask (FAtoGDB.c:115-125)
                anom.write_ano(str(root) + ".1ano", gdb, masks)

        gix_masks = None
        if mask_files:
            lists = []
            for m in mask_files:
                mp = m if m else str(root) + ".1ano"
                lists.append(anom.read_ano(mp, gdb))
            gix_masks = anom.ano_union(lists)
        elif soft_mask:
            ano_file = Path(str(root) + ".1ano")
            if ano_file.exists():
                gix_masks = anom.read_ano(ano_file, gdb)
            elif masks:
                gix_masks = masks

        gixp = Path(str(root) + ".gix")
        if gixp.exists() and not gix_masks:
            table = gixm.read_gix(root)
        elif lazy and not keep and not gix_masks:
            table = None       # the device pipeline builds the index
        else:
            if verbose:
                sys.stderr.write(f"  Creating genome index (GIX) {root}.gix"
                                 f"{' (in memory)' if not keep else ''}\n")
            table = build_index(gdb, nthreads, device, gix_masks)
            if keep:
                gixm.write_gix(table, root, nthreads=nthreads)
        return gdb, table


def index_on_card(kmer: int, nthreads: int) -> bool:
    """Whether ``build_index`` builds on the card (k = 40, -T8)."""
    return kmer == KMER and nthreads == 8


def build_index(gdb, nthreads: int, device, masks=None, kmer: int = KMER):
    """``gdb``'s GIX table with ``masks``' bytes: ``build_gix_device`` on
    ``device`` where ``index_on_card``, else the host's ``build_gix``."""
    if index_on_card(kmer, nthreads):
        from ..ops.device_pipeline import build_gix_device
        return build_gix_device(gdb, device, masks=masks)
    from ..io import gix as gixm
    return gixm.build_gix(gdb, kmer=kmer, masks=masks, nthreads=nthreads)


def resolve_gdb(path: str, verbose: bool = False):
    """Input -> GDB only (no index), building from FASTA in memory if
    needed (the converters' Get_GDB pattern, ALNtoPAF.c:733-752)."""
    from ..io import gdb as gdbm

    t, p = infer_source(path)
    root = _root(p)
    if t in ("gdb", "gix"):
        return gdbm.read_gdb(root)
    gdb, _ = gdbm.create_gdb(p, target=None)
    return gdb


def open_aln(path: str, prog: str):
    """Open a .1aln and resolve its two source GDBs from the header
    references (db paths relative to the recorded cpath when needed)."""
    from ..io import alncode

    p = Path(path)
    if not p.name.endswith(".1aln"):
        q = Path(str(p) + ".1aln")
        if q.exists():
            p = q
    if not p.exists():
        raise ArgError(prog, f"cannot find alignment file {path}")
    af = alncode.read_aln(p)

    def find(name):
        if not name:
            return None
        cand = Path(name)
        tries = [cand]
        if not cand.is_absolute():
            if af.cpath:
                tries.append(Path(af.cpath) / name)
            tries.append(p.parent / name)
        else:
            # stale absolute reference (e.g. recorded under a temp dir
            # that is gone): fall back to the basename beside the .1aln,
            # the same relocation ALNreset exists to repair
            tries.append(p.parent / cand.name)
        for t in tries:
            try:
                infer_source(str(t))
                return resolve_gdb(str(t))
            except (SystemExit, FileNotFoundError):
                continue
        raise ArgError(prog, f"cannot find source {name} referenced by {p}")

    gdb1 = find(af.db1_name)
    gdb2 = find(af.db2_name) if af.db2_name else gdb1
    if gdb1 is None:
        if af.skeletons:
            gdb1 = af.skeletons[0]
            gdb2 = af.skeletons[1] if len(af.skeletons) > 1 else gdb1
        else:
            raise ArgError(prog, f"{p} has no source references or skeletons")
    return af, gdb1, gdb2


def _root(p: Path) -> Path:
    name = p.name
    for ext in (".gix", ".1gdb", ".gdb") + FASTA_EXTS:
        if name.endswith(ext):
            return p.parent / name[: -len(ext)]
    return p


def run_sliced(items, nthreads: int, worker):
    """P8: slice `items` into `nthreads` contiguous ranges and run
    `worker(slice_items) -> list[str]` per range in a thread, emitting
    results in slice order (the reference's oneGoto threading pattern,
    ALNtoPAF.c:165-171, 836-848).  The heavy per-record work (native
    trace reconstruction) drops the GIL, so threads genuinely overlap."""
    n = len(items)
    if nthreads <= 1 or n < 4 * nthreads:
        return worker(items)
    import threading

    bounds = [(p * n) // nthreads for p in range(nthreads + 1)]
    out = [None] * nthreads
    errs = [None] * nthreads

    def go(p):
        try:
            out[p] = worker(items[bounds[p]:bounds[p + 1]])
        except BaseException as e:   # re-raised on the main thread
            errs[p] = e

    ts = [threading.Thread(target=go, args=(p,)) for p in range(nthreads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for e in errs:
        if e is not None:
            raise e
    res = []
    for part in out:
        res.extend(part)
    return res


def _exit_now(rc: int) -> None:
    """Flush and exit WITHOUT interpreter teardown, as the C tools end:
    the output is complete when ``main`` returns (``-1:`` closes its
    writer there), and after a closed stdout pipe a teardown flush would
    only raise again."""
    import os
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(rc)


def cli_exit(main) -> None:
    """Entry-point wrapper: run ``main()`` and exit, dying silently on a
    closed stdout pipe the way the C tools do under SIGPIPE (e.g.
    ``gixshow ... | head``)."""
    import os
    try:
        rc = main()
        _exit_now(int(rc) if rc else 0)
    except SystemExit as e:
        code = e.code
        _exit_now(code if isinstance(code, int) else (0 if code is None
                                                      else 1))
    except BrokenPipeError:
        # re-point stdout at devnull so interpreter shutdown doesn't
        # raise a second BrokenPipeError from the final flush
        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        _exit_now(141)   # 128 + SIGPIPE, the shell convention

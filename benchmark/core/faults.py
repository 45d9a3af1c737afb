"""Faults planted under the timed path, and the control, for the checks
that ``correct`` rests on.

Each is a context manager that puts a wrapper in place of a module
attribute of the program for its duration (``none`` plants nothing: a
sound run, for the lower readings):

- ``dedup_off`` (the control of the cells without -M):
  ``models.aligner.dedup_group`` returns its records unchanged, so the
  redundancy elimination is skipped; it breaks the configurations' stated
  guarantee that no two records of a contig pair and strand share a start
  or an end;
- ``comp_off`` (the control of the PAF cell, where dedup finds nothing
  to remove): the device seed routes return no tube on B's reverse
  complement, so only the forward strand is aligned; it breaks the
  guarantee that both strands of B are searched;
- ``masks_off`` (the control of the -M cells): the command line is run
  without -M, so seeds come from soft-masked bases too; it breaks -M's
  guarantee that no alignment starts from a masked seed;
- ``half_left_out``: ``align_genomes`` returns every other record;
- ``answer_altered``: ``align_genomes`` returns its longest record with
  the differences of one trace panel set to 0 (and its total lowered to
  match), a record that states fewer differences than its sequences have;
- ``diffs_added``: every record states one difference more in every
  tenth trace panel (one a 1,000 A bases), as a wave that takes a worse
  path would;
- ``ends_cut``: every record of two panels or more ends early, its last
  twentieth of panels (at least one) dropped with their B advances and
  differences, as a wave that stops short would;
- ``trace_broken``, ``contig_swapped``, ``file_truncated``,
  ``index_kept``: further faults for the exact counts (a B advance raised
  by one; a record's B contig moved to the next contig; the output file
  cut in half after the job; -k passed, so the index files stay beside
  the inputs).
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext


@contextmanager
def _patched(mod, attr, new):
    old = getattr(mod, attr)
    setattr(mod, attr, new)
    try:
        yield
    finally:
        setattr(mod, attr, old)


@contextmanager
def dedup_off():
    from fastga_tpu_torch.models import aligner
    with _patched(aligner, "dedup_group",
                  lambda ovls: sorted(ovls, key=lambda o: o.abpos)):
        yield


def _on_records(change):
    from fastga_tpu_torch.models import aligner
    real = aligner.align_genomes

    def w(*a, **k):
        out, stats = real(*a, **k)
        return change(out, a[1] if len(a) > 1 else k.get("gdb2")), stats
    return _patched(aligner, "align_genomes", w)


@contextmanager
def half_left_out():
    with _on_records(lambda out, g2: out[::2]):
        yield


def _longest(out):
    return max(range(len(out)), key=lambda i: out[i].aepos - out[i].abpos)


def _alter(out, g2):
    if out:
        o = out[_longest(out)]
        for k, (d, b) in enumerate(o.trace):
            if d > 0:
                o.trace = list(o.trace)
                o.trace[k] = (0, b)
                o.diffs -= d
                break
    return out


@contextmanager
def answer_altered():
    with _on_records(_alter):
        yield


def _add_diffs(out, g2):
    for o in out:
        tr = list(o.trace)
        for k in range(9, len(tr), 10):
            d, b = tr[k]
            tr[k] = (d + 1, b)
            o.diffs += 1
        o.trace = tr
    return out


@contextmanager
def diffs_added():
    with _on_records(_add_diffs):
        yield


def _cut_ends(out, g2, T=100):
    for o in out:
        k = len(o.trace)
        if k < 2:
            continue
        keep = k - max(1, k // 20)
        gone = o.trace[keep:]
        o.trace = list(o.trace[:keep])
        o.aepos = (o.abpos // T + keep) * T
        o.bepos -= sum(b for _, b in gone)
        o.diffs -= sum(d for d, _ in gone)
    return out


@contextmanager
def ends_cut():
    with _on_records(_cut_ends):
        yield


def _break_trace(out, g2):
    if out:
        o = out[_longest(out)]
        d, b = o.trace[0]
        o.trace = [(d, b + 1)] + list(o.trace[1:])
    return out


@contextmanager
def trace_broken():
    with _on_records(_break_trace):
        yield


def _swap(out, g2):
    if out and g2.ncontig > 1:
        o = out[_longest(out)]
        o.bread = (o.bread + 1) % g2.ncontig
        lim = g2.contigs[o.bread].clen
        if o.bepos > lim:
            o.bepos, o.bbpos = lim, max(0, lim - (o.bepos - o.bbpos))
    return out


@contextmanager
def contig_swapped():
    with _on_records(_swap):
        yield


@contextmanager
def file_truncated():
    """The job's output file cut to half its bytes once the job ends."""
    import os

    from . import harness
    real = harness.Runner.job

    def job(self, files, name):
        j = real(self, files, name)
        size = os.path.getsize(j["out"])
        with open(j["out"], "r+b") as f:
            f.truncate(size // 2)
        return j
    with _patched(harness.Runner, "job", job):
        yield


@contextmanager
def comp_off():
    import dataclasses

    from fastga_tpu_torch.ops import device_pipeline as dp
    names = ("device_tubes", "device_tubes_self", "device_tubes_paneled",
             "device_tubes_tables")
    real = {n: getattr(dp, n) for n in names}

    def forward_only(name):
        def w(*a, **k):
            res = real[name](*a, **k)
            if res is None:
                return None
            tubes, rest = res[0], res[1:]
            keep = ~tubes.comp.astype(bool)
            return (type(tubes)(**{f.name: getattr(tubes, f.name)[keep]
                                   for f in dataclasses.fields(tubes)}),
                    ) + tuple(rest)
        return w
    for n in names:
        setattr(dp, n, forward_only(n))
    try:
        yield
    finally:
        for n in names:
            setattr(dp, n, real[n])


@contextmanager
def masks_off():
    from fastga_tpu_torch.cli import fastga
    real = fastga.main

    def main(argv=None, device=None):
        return real([x for x in argv if x != "-M"], device=device)
    with _patched(fastga, "main", main):
        yield


@contextmanager
def index_kept():
    from fastga_tpu_torch.cli import fastga
    real = fastga.main

    def main(argv=None, device=None):
        return real(["-k"] + list(argv), device=device)
    with _patched(fastga, "main", main):
        yield


FAULTS = {"none": nullcontext, "dedup_off": dedup_off, "comp_off": comp_off,
          "masks_off": masks_off, "half_left_out": half_left_out,
          "answer_altered": answer_altered, "diffs_added": diffs_added,
          "ends_cut": ends_cut, "trace_broken": trace_broken,
          "contig_swapped": contig_swapped, "file_truncated": file_truncated,
          "index_kept": index_kept}

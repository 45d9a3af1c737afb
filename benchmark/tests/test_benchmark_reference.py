"""The plain reference on its own: its readers, its edit distance and its
verdict on a real job's files and on records changed one field at a
time."""

import contextlib
import dataclasses
import random

import numpy as np
import pytest
import torch

from core import gen, spec
from reference import editdist, judge, onealn

RULES = dict(options=["-l100", "-i.7"])
LIMITS = spec.limits()
GEN = {"kind": "uniform_pair", "params": {"ncontig": 4, "clen": 2000}}
SEED = 2 ** 33 + 11


def naive(a, b):
    D = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        P, D = D, np.empty(len(b) + 1, np.int64)
        D[0] = i
        for j in range(1, len(b) + 1):
            D[j] = min(P[j] + 1, D[j - 1] + 1, P[j - 1] + (a[i - 1] != b[j - 1]))
    return int(D[-1])


def pieces(seed, n=50):
    rng = np.random.default_rng(seed)
    A, B = [], []
    for _ in range(n):
        a = rng.integers(0, 4, rng.integers(1, 70)).astype(np.uint8)
        b = a.copy()
        for _ in range(rng.integers(0, 12)):
            p = int(rng.integers(0, len(b) + 1))
            op = rng.integers(3)
            if op == 0 and p < len(b):
                b[p] = (b[p] + 1) % 4
            elif op == 1:
                b = np.insert(b, p, rng.integers(4)).astype(np.uint8)
            elif len(b) > 1 and p < len(b):
                b = np.delete(b, p)
        A.append(a)
        B.append(b)
    la = torch.tensor([len(x) for x in A])
    lb = torch.tensor([len(x) for x in B])
    return (torch.from_numpy(np.concatenate(A)), torch.cumsum(la, 0) - la,
            la, torch.from_numpy(np.concatenate(B)), torch.cumsum(lb, 0) - lb,
            lb, [naive(a, b) for a, b in zip(A, B)])


@pytest.mark.parametrize("seed", [1, 2])
def test_edit_distance_against_the_textbook_loop(seed):
    sa, st_a, la, sb, st_b, lb, want = pieces(seed)
    assert editdist.panels(sa, st_a, la, sb, st_b, lb).tolist() == want
    assert editdist.banded(sa, st_a, la, sb, st_b, lb, 100).tolist() == want
    narrow = editdist.banded(sa, st_a, la, sb, st_b, lb, 3).tolist()
    assert all(x == -1 or x >= w for x, w in zip(narrow, want))


@pytest.mark.parametrize("options,want", [
    ([], (100, 0.7, 85, False)),
    (["-f10", "-c85", "-l100", "-i.7", "-T8"], (100, 0.7, 85, False)),
    (["-l250", "-i.85", "-c100", "-M"], (250, 0.85, 100, True))])
def test_rules_come_from_the_job_options(options, want):
    assert judge.job_rules(options) == want


def test_onealn_reader_reads_what_the_writer_wrote(tmp_path):
    from fastga_tpu_torch.io import alncode
    from fastga_tpu_torch.utils import synth
    g, _ = synth.to_gdb("a", [np.zeros(1000, np.uint8),
                              np.ones(2000, np.uint8)])
    rnd = random.Random(5)
    ovls = []
    for _ in range(12000):          # past the codec's training bytes
        ab = rnd.randrange(0, 800)
        ae = ab + rnd.randrange(100, 3000)
        tr = [(rnd.randrange(0, 30), rnd.randrange(50, 150))
              for _ in range((ae - 1) // 100 - ab // 100 + 1)]
        ovls.append(alncode.Overlap(rnd.randrange(2), rnd.randrange(2), ab,
                                    ae, 5, 5 + sum(b for _, b in tr),
                                    sum(d for d, _ in tr),
                                    rnd.random() < 0.5, tr))
    path = str(tmp_path / "x.1aln")
    w = alncode.AlnWriter(path, 100, "/a", "/b", "/", command="fastga")
    w.write_skeleton(g)
    w.write_skeleton(g)
    for o in ovls:
        w.write_overlap(o)
    w.close()
    skel, recs, counts = onealn.read_aln(path)
    assert skel == [[1000, 2000], [1000, 2000]]
    assert counts["A"] == len(ovls) == len(recs)
    got = [(r.a, r.b, r.comp, r.ab, r.ae, r.bb, r.be, r.diffs, r.trace)
           for r in recs]
    want = [(o.aread, o.bread, o.bcomp, o.abpos, o.aepos, o.bbpos, o.bepos,
             o.diffs, [tuple(t) for t in o.trace]) for o in ovls]
    assert got == want


@pytest.fixture(scope="module")
def job_files(tmp_path_factory, cpu_engine):
    """One tiny pair through ``fastga A B`` (PAF) and ``fastga -1:``."""
    from fastga_tpu_torch.cli import fastga
    d = tmp_path_factory.mktemp("job")
    pair = gen.make_pair(GEN, SEED, 0)
    a, b = gen.write_pair(pair, str(d), "p0")
    paf = str(d / "out.paf")
    with open(paf, "w") as f, contextlib.redirect_stdout(f):
        fastga.main([a, b], device="cpu")
    fastga.main([f"-1:{d / 'out.1aln'}", a, b], device="cpu")
    return dict(a=a, b=b, paf=paf, aln=str(d / "out.1aln"), dir=d)


def verdict(job_files, form, out=None):
    out = out or job_files["paf" if form == "paf" else "aln"]
    jobs = [dict(pair=0, a_fa=job_files["a"], b_fa=job_files["b"], out=out,
                 form=form)]
    return judge.judge(jobs, RULES, lambda k: gen.make_pair(GEN, SEED, k),
                       torch.device("cpu"))


@pytest.mark.parametrize("form", ["paf", "1aln"])
def test_a_real_job_passes(job_files, form):
    num, info = verdict(job_files, form)
    assert info["records"] >= 4
    assert all(v <= LIMITS[k] for k, v in num.items()), num


def rewrite(job_files, name, change):
    """The job's .1aln with ``change(records)`` applied, written again by
    the program's writer."""
    from fastga_tpu_torch.io import alncode
    af = alncode.read_aln(job_files["aln"])
    recs = [dataclasses.replace(o, trace=list(o.trace)) for o in af.overlaps]
    change(recs)
    path = str(job_files["dir"] / name)
    w = alncode.AlnWriter(path, af.tspace, af.db1_name, af.db2_name,
                          af.cpath)
    for g in af.skeletons:
        w.write_skeleton(g)
    for o in recs:
        w.write_overlap(o)
    w.close()
    return verdict(job_files, "1aln", path)[0]


def _longest(recs):
    return max(recs, key=lambda o: o.aepos - o.abpos)


def _aepos_minus_one(recs):
    _longest(recs).aepos -= 1


def _bbpos_plus_one(recs):
    _longest(recs).bbpos += 1


def _trace_point_plus_one(recs):
    o = _longest(recs)
    d, b = o.trace[3]
    o.trace[3] = (d, b + 1)


def _panel_diffs_lowered(recs):
    o = _longest(recs)
    k = next(k for k, (d, _) in enumerate(o.trace) if d > 0)
    d, b = o.trace[k]
    o.trace[k] = (0, b)
    o.diffs -= d


def _panel_diffs_raised(recs):
    o = _longest(recs)
    d, b = o.trace[2]
    o.trace[2] = (d + 5, b)
    o.diffs += 5


def _aepos_past_the_contig(recs):
    _longest(recs).aepos = 10 ** 7


def _diffs_past_the_filter(recs):
    o = _longest(recs)
    d, b = o.trace[0]
    extra = int(0.4 * (o.aepos - o.abpos))
    o.trace[0] = (d + extra, b)
    o.diffs += extra


def _record_twice(recs):
    recs.append(dataclasses.replace(_longest(recs)))


@pytest.mark.parametrize("change,number", [
    (_aepos_minus_one, "lies"), (_bbpos_plus_one, "bad_trace"),
    (_trace_point_plus_one, "bad_trace"), (_panel_diffs_lowered, "lies"),
    (_panel_diffs_raised, "excess_share"),
    (_record_twice, "redundant"), (_aepos_past_the_contig, "bad_format"),
    (_diffs_past_the_filter, "filter_miss")])
def test_one_changed_field_fails(job_files, change, number):
    num = rewrite(job_files, change.__name__ + ".1aln", change)
    same = rewrite(job_files, "same.1aln", lambda recs: None)
    assert num[number] > same[number], num


def test_unchanged_rewrite_passes(job_files):
    num = rewrite(job_files, "same.1aln", lambda recs: None)
    assert all(v <= LIMITS[k] for k, v in num.items()), num


def test_a_cut_file_is_unreadable(job_files, tmp_path):
    data = open(job_files["aln"], "rb").read()
    cut = tmp_path / "cut.1aln"
    cut.write_bytes(data[:len(data) // 2])
    assert verdict(job_files, "1aln", str(cut))[0]["unreadable"] == 1


def test_paf_with_lowered_differences_lies(job_files, tmp_path):
    lines = open(job_files["paf"]).read().splitlines()
    col = lines[0].split("\t")
    df = int(col[13].split(":")[2])
    span = (int(col[3]) - int(col[2])) + (int(col[8]) - int(col[7]))
    col[13] = f"df:i:{df // 2}"
    col[9] = str((span - df // 2) // 2)
    bad = tmp_path / "bad.paf"
    bad.write_text("\n".join(["\t".join(col)] + lines[1:]) + "\n")
    assert verdict(job_files, "paf", str(bad))[0]["lies"] == 1

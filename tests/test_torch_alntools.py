"""The port's alignment tools and ONEaln library (fastga_tpu_torch.cli:
alnchain, alnplot, alnshow, alntopsl, alnreset, oneview, paftoaln,
paftopsl; fastga_tpu_torch.api; io.show, ops.exact, ops.chainfilter and
wave_ref's extension and wrap-around) against the C goldens and against
the JAX package's tools and functions, byte for byte, case for case as
tests/test_alnchain.py, tests/test_api.py, tests/test_alignlib.py, the
ALNshow and ALNtoPSL cases of tests/test_convert.py,
tests/test_onecode_binary.py::test_oneview_roundtrip and
tests/test_anotools.py::test_alnreset.  Each .1aln input is written once
by the port's ``fastga -Eref`` (``device="cpu"``); both packages' tools
then read that same file.  Every output is text or integers; the
tolerance is zero."""

import io
import json
import re
import shutil
import types
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu import api as japi
from fastga_tpu.cli import (alnchain as jalnchain, alnplot as jalnplot,
                            alnreset as jalnreset, alnshow as jalnshow,
                            alntopsl as jalntopsl, oneview as joneview,
                            paftoaln as jpaftoaln, paftopsl as jpaftopsl)
from fastga_tpu.io import onecode as jonecode
from fastga_tpu.io import show as jshow
from fastga_tpu.ops import exact as jexact
from fastga_tpu.ops import wave_ref as jwr
from fastga_tpu_torch import api
from fastga_tpu_torch.cli import (alnchain, alnplot, alnreset, alnshow,
                                  alntopaf, alntopsl, fastga, oneview,
                                  paftoaln, paftopsl)
from fastga_tpu_torch.io import alncode
from fastga_tpu_torch.io import onecode as tonecode
from fastga_tpu_torch.io import show
from fastga_tpu_torch.ops import exact as ex
from fastga_tpu_torch.ops import tracerec as tr
from fastga_tpu_torch.ops import wave_ref as wr
from fastga_tpu_torch.utils import dna
from tests.test_gdb import write_fasta
from tests.test_gdbtools import _make_fasta
from tests.test_torch_tools import both, run
from tests.test_wave_ref import diverged_pair

GOLD = Path(__file__).parent / "golden"
AL = "acgt"


@pytest.fixture(scope="module", autouse=True)
def _one_thread_same_date():
    """One torch thread; the provenance line's date equal in both
    packages' writers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fixed = types.SimpleNamespace(strftime=lambda fmt: "2026-01-01_00:00:00")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jonecode, "time", fixed)
        mp.setattr(tonecode, "time", fixed)
        yield
    torch.set_num_threads(n)


def both_file(jmain, tmain, args, out):
    """The file ``out`` that the JAX tool and then the port's write on
    the same arguments, which must be equal; the port's stays."""
    run(jmain, args)
    want = out.read_bytes()
    out.unlink()
    run(tmain, args)
    assert out.read_bytes() == want


def port_fastga(args):
    run(lambda a: fastga.main(a, device="cpu"), ["-Eref"] + args)


def _wrap(s):
    return "\n".join(s[i:i + 70] for i in range(0, len(s), 70))


@pytest.fixture(scope="module")
def rr_aln(tmp_path_factory):
    """tests/test_alnchain.py's rearranged pair (five segments, two B
    contigs) through the port's `fastga -1:`."""
    tmp = tmp_path_factory.mktemp("tchain")
    rng = np.random.default_rng(4242)

    def mut(x, r=.04):
        x = x.copy()
        m = rng.random(len(x)) < r
        x[m] = (x[m] + rng.integers(1, 4, m.sum())) % 4
        return x

    segs = [rng.integers(0, 4, n) for n in (8000, 6000, 7000, 5000, 9000)]
    A = np.concatenate(segs)
    Bparts = [mut(segs[2]), mut(segs[0]), (3 - mut(segs[3]))[::-1],
              mut(segs[0]), mut(segs[4]), mut(segs[1][:3000]),
              mut(segs[1][2000:])]
    B = np.concatenate(Bparts)
    (tmp / "A.fasta").write_text(
        ">a1\n" + _wrap("".join(AL[v] for v in A)) + "\n")
    cut = len(B) // 2
    (tmp / "B.fasta").write_text(
        ">b1\n" + _wrap("".join(AL[v] for v in B[:cut])) + "\n>b2\n"
        + _wrap("".join(AL[v] for v in B[cut:])) + "\n")
    out = tmp / "rr.1aln"
    port_fastga([f"-1:{out}", str(tmp / "A.fasta"), str(tmp / "B.fasta")])
    return out


@pytest.fixture(scope="module")
def ef_aln(tmp_path_factory):
    """tests/test_convert.py's E/F pair through the port's `fastga -1:`."""
    tmp = tmp_path_factory.mktemp("tconv")
    a, b = diverged_pair()
    write_fasta(tmp / "E.fasta", [("e1", dna.to_ascii(a, True).decode())])
    write_fasta(tmp / "F.fasta", [("f1", dna.to_ascii(b, True).decode())])
    out = tmp / "ours.1aln"
    port_fastga([f"-1:{out}", str(tmp / "E.fasta"), str(tmp / "F.fasta")])
    return out


def _spans(path):
    return [[o.aread, o.abpos, o.aepos, o.bread, o.bbpos, o.bepos]
            for o in alncode.read_aln(path).overlaps]


# -- ALNchain, PAFtoALN, PAFtoPSL, ALNtoPSL, ALNplot (tests/test_alnchain.py)


@pytest.mark.parametrize("tag,flags", [
    ("default", []),
    ("s1000", ["-s1000"]),
    ("cf", ["-c0.1", "-f200"]),
    ("n3", ["-n3", "-s500"]),
])
def test_alnchain_matches_reference(rr_aln, tag, flags, tmp_path):
    out = tmp_path / f"{tag}.1aln"
    both_file(jalnchain.main, alnchain.main, flags + [f"-o{out}", str(rr_aln)],
              out)
    assert _spans(out) == json.load(open(GOLD / "alnchain.json"))[tag]


def test_alnchain_default_output_name(rr_aln, tmp_path):
    src = tmp_path / "rr.1aln"
    shutil.copy(rr_aln, src)
    out = tmp_path / "rr.chain.1aln"
    both_file(jalnchain.main, alnchain.main, [str(src)], out)
    assert _spans(out) == json.load(open(GOLD / "alnchain.json"))["default"]


@pytest.fixture(scope="module")
def rr_paf(rr_aln):
    paf = rr_aln.parent / "rrx.paf"
    paf.write_text(run(alntopaf.main, ["-x", str(rr_aln)]))
    return paf


def test_paftoaln_matches_reference(rr_aln, rr_paf, tmp_path):
    paf = tmp_path / "rr.paf"
    shutil.copy(rr_paf, paf)
    fa = rr_aln.parent
    both_file(jpaftoaln.main, paftoaln.main,
              [str(paf), str(fa / "A.fasta"), str(fa / "B.fasta")],
              tmp_path / "rr.1aln")
    got = [[o.aread, o.abpos, o.aepos, o.bread, o.bbpos, o.bepos,
            int(o.bcomp), o.diffs]
           for o in alncode.read_aln(tmp_path / "rr.1aln").overlaps]
    assert got == json.load(open(GOLD / "paftoaln.json"))


def test_paftopsl_matches_reference(rr_paf):
    got = both(jpaftopsl.main, paftopsl.main, [str(rr_paf)])
    assert got == (GOLD / "paftopsl.txt").read_text()


def test_psl_consistency(rr_aln, rr_paf):
    """PSL via .1aln directly == PSL via PAF+CIGAR."""
    assert both(jalntopsl.main, alntopsl.main, [str(rr_aln)]) == \
        run(paftopsl.main, [str(rr_paf)])


@pytest.mark.parametrize("args,golden", [
    ([], "plot_default.eps"),
    (["-L", "-G"], "plot_LG.eps"),
    (["-S", "-W800"], "plot_SW_sel.eps"),
])
def test_alnplot_matches_reference(rr_aln, args, golden):
    sel = ["@1-", "@1"] if golden == "plot_SW_sel.eps" else []
    got = both(jalnplot.main, alnplot.main, args + [str(rr_aln)] + sel)
    assert got == (GOLD / golden).read_text()


# -- ALNtoPSL and ALNshow (tests/test_convert.py) -----------------------------


def test_alntopsl_matches_reference(ef_aln):
    got = both(jalntopsl.main, alntopsl.main, [str(ef_aln)])
    assert got == (GOLD / "ref_psl.txt").read_text()


def _show_gold(name, aln):
    # the reference prints the .1aln root name in the banner
    return (GOLD / name).read_text().replace("\nours:", f"\n{aln.stem}:")


@pytest.mark.parametrize("args,golden", [
    ([], "ref_show_plain.txt"),
    (["-a"], "ref_show_a.txt"),
    (["-r", "-w60"], "ref_show_r_w60.txt"),
    (["-a", "-n"], "ref_show_a_n.txt"),
])
def test_alnshow_matches_reference(ef_aln, args, golden):
    got = both(jalnshow.main, alnshow.main, args + [str(ef_aln)])
    assert got == _show_gold(golden, ef_aln)


def test_alnshow_selection_reverse(ef_aln):
    got = both(jalnshow.main, alnshow.main, [str(ef_aln), "@1-", "@1"])
    assert got == _show_gold("ref_show_sel_rev.txt", ef_aln)


def test_alnshow_border0(ef_aln):
    got = both(jalnshow.main, alnshow.main,
               ["-a", "-b0", str(ef_aln), "@1:0-12k"])
    assert got == _show_gold("ref_show_a_b0_sel.txt", ef_aln)


# -- oneview and alnreset -----------------------------------------------------


def test_oneview_roundtrip(tmp_path):
    p = tmp_path / "v.1aln"
    w = alncode.AlnWriter(p, 100, "a", "b", "/c", binary=True)
    w.write_overlap(alncode.Overlap(0, 0, 0, 100, 0, 100, 1, False,
                                    [(1, 100)]))
    w.close()
    text = both(joneview.main, oneview.main, [str(p)])
    assert text.startswith("1 3 aln")
    assert "A 0 0 100 0 0 100" in text
    # binary re-emission readable again
    out2 = tmp_path / "v2.1aln"
    both_file(joneview.main, oneview.main, ["-b", "-o", str(out2), str(p)],
              out2)
    af = alncode.read_aln(out2)
    assert len(af.overlaps) == 1 and af.overlaps[0].aepos == 100


def test_oneview_ascii_binary_ascii(ef_aln, tmp_path):
    """fastga's binary .1aln to ASCII, to binary and to ASCII again keeps
    every data line and record, each step the JAX tool's bytes."""
    a1, b1, a2 = (tmp_path / n for n in ("a1.1aln", "b1.1aln", "a2.1aln"))
    for args, out in ((["-o", str(a1), str(ef_aln)], a1),
                      (["-b", "-o", str(b1), str(a1)], b1),
                      (["-o", str(a2), str(b1)], a2)):
        both_file(joneview.main, oneview.main, args, out)
    assert a1.read_text().startswith("1 3 aln")
    data = [both(joneview.main, oneview.main, ["-h", str(p)])
            for p in (ef_aln, a1, b1, a2)]
    assert data == [data[0]] * 4 and data[0].count("\nA ") == 3
    assert [o.trace for o in alncode.read_aln(b1).overlaps] == \
        [o.trace for o in alncode.read_aln(ef_aln).overlaps]


def test_alnreset(tmp_path):
    p = tmp_path / "r.1aln"
    w = alncode.AlnWriter(p, 100, "old1", "old2", "/old")
    w.write_overlap(alncode.Overlap(0, 0, 0, 100, 0, 100, 1, False,
                                    [(1, 100)]))
    w.close()
    orig = p.read_bytes()
    fa = tmp_path / "G.fasta"
    _make_fasta(fa)
    run(jalnreset.main, [str(p), str(fa), str(fa)])
    want = p.read_bytes()
    p.write_bytes(orig)
    run(alnreset.main, [str(p), str(fa), str(fa)])
    assert p.read_bytes() == want
    af = alncode.read_aln(p)
    assert af.db1_name == str(fa) and af.db2_name == str(fa)
    assert len(af.overlaps) == 1 and af.overlaps[0].trace == [(1, 100)]


# -- AlnReader (tests/test_api.py) --------------------------------------------


@pytest.fixture(scope="module")
def readers(ef_aln):
    return api.AlnReader(ef_aln), japi.AlnReader(ef_aln)


def test_counts(readers):
    reader, jreader = readers
    assert reader.count == 3
    assert reader.trace_spacing == 100
    assert reader.trace_max == 101
    assert reader.trace_count == sum(len(o.trace)
                                     for o in reader._af.overlaps)
    assert (reader.count, reader.trace_spacing, reader.trace_max,
            reader.trace_count) == (jreader.count, jreader.trace_spacing,
                                    jreader.trace_max, jreader.trace_count)


def test_gdb_accessors(readers):
    g1, jg1 = readers[0].gdb1, readers[1].gdb1
    assert g1.scaffold_count == 1
    assert g1.contig_count == 1
    assert g1.gap_count == 0
    assert g1.scaffold_name(1) == "e1"
    assert g1.scaffold_len(1) == 30000
    assert g1.contig_len(1, 1) == 30000
    assert g1.contig_start(1, 1) == 0
    with pytest.raises(api.AlnError):
        g1.scaffold_len(2)
    seq = g1.scaffold_seq(1, 100, 150)
    assert len(seq) == 50 and set(seq) <= set("acgt")
    assert seq == jg1.scaffold_seq(1, 100, 150)


def _fields(rec):
    return (rec.seq1, rec.bpos1, rec.epos1, rec.seq2, rec.bpos2, rec.epos2,
            rec.complement, rec.diffs, list(rec.tpoints))


def test_records_and_cursor(readers):
    reader, jreader = readers
    recs = list(reader)
    assert len(recs) == 3
    assert [_fields(r) for r in recs] == [_fields(r) for r in jreader]
    r0 = recs[0]
    assert (r0.seq1, r0.bpos1, r0.epos1) == (1, 0, 10025)
    assert r0.diffs == 504
    assert sum(r0.tpoints) == r0.epos2 - r0.bpos2
    r1 = recs[1]
    assert r1.complement
    assert r1.bpos2 > r1.epos2   # complemented: descending scaffold coords
    reader.goto(2)
    assert not reader.eof
    rec = reader.alignment()
    assert rec.seq1 == 1 and rec.complement
    assert reader.next() is False
    assert reader.next() is True  # past the last record


_OPS = re.compile(r"(\d+)([MIDX=])")


def _count(s, letters):
    return sum(int(n) for n, op in _OPS.findall(s) if op in letters)


def test_cigar_cs_indels(readers):
    rec, jrec = readers[0][0], readers[1][0]
    cg = rec.cigar()
    # ONEaln's I/D letters mirror the PAF cg:Z convention: M+D consume
    # seq1, M+I consume seq2
    assert _count(cg, "MX=D") == rec.epos1 - rec.bpos1
    assert _count(cg, "MX=I") == rec.epos2 - rec.bpos2
    cgx = rec.cigar(show_x=True)
    assert "X" in cgx and "=" in cgx and "M" not in cgx
    cs = rec.cs_tag(short_form=True)
    assert cs.startswith(":")
    ind = rec.indel_array()
    assert all(v != 0 for v in ind)
    # indel count == diffs - substitutions
    assert len(ind) == _count(cg, "ID")
    assert (cg, cgx, cs, list(ind)) == (
        jrec.cigar(), jrec.cigar(show_x=True), jrec.cs_tag(short_form=True),
        list(jrec.indel_array()))


def test_show_alignment(readers):
    texts = []
    for r in readers:
        buf = io.StringIO()
        r[0].show_alignment(buf, width=100, border=10, coord=5)
        texts.append(buf.getvalue())
    assert "|" in texts[0] and texts[0].count("\n") > 100
    assert texts[0] == texts[1]


def test_reversed_cigar(readers):
    rec = readers[0][1]  # complemented record
    fwd = rec.cigar()
    rev = rec.cigar(reversed=True)
    assert fwd != rev
    # role swap exchanges I and D counts
    assert _count(fwd, "I") == _count(rev, "D")
    assert _count(fwd, "D") == _count(rev, "I")
    assert rev == readers[1][1].cigar(reversed=True)


def test_onealn_oracle_parity():
    """Byte parity with the reference's ONEalnTEST capture
    (tests/golden/onealn/) for every derivation in both directions:
    cigar, CS, indel array and the reversed BLAST display; and the JAX
    package's reader on the same file."""
    gdir = GOLD / "onealn"
    gold = json.loads((gdir / "oracle.json").read_text())
    r = api.AlnReader(gdir / "apigold.1aln")
    jr = japi.AlnReader(gdir / "apigold.1aln")
    assert r.count == len(gold["cig_f"])

    def derived(rec):
        buf = io.StringIO()
        rec.show_alignment(buf, indent=8, width=100, border=10, coord=9,
                           reversed=True)
        return (rec.cigar(show_x=True), rec.cigar(show_x=True, reversed=True),
                rec.cs_tag(False, False), rec.cs_tag(False, True),
                " ".join(map(str, rec.indel_array(False))),
                " ".join(map(str, rec.indel_array(True))), buf.getvalue())

    for i in range(r.count):
        got = derived(r[i])
        assert got == derived(jr[i])
        assert got[:6] == (gold["cig_f"][i], gold["cig_r"][i],
                           gold["cs_f"][i], gold["cs_r"][i],
                           gold["ind_f"][i], gold["ind_r"][i])
        want = gold["show_r"][i].split("\n")
        ours = got[6].rstrip("\n").split("\n")
        assert ours == want[:len(ours)], f"record {i} reversed display"


# -- align.c library API (tests/test_alignlib.py) -----------------------------


@pytest.fixture(scope="module")
def gold():
    return json.loads((GOLD / "alignlib.json").read_text())


MODES = {0: tr.GREEDIEST, 1: tr.UPPERMOST, -1: tr.LOWERMOST}


def _seqs(case):
    return np.array(case["A"], np.uint8), np.array(case["B"], np.uint8)


def test_compute_trace_mid(gold):
    for case in gold["mid"]:
        A, B = _seqs(case)
        t, d = tr.compute_trace_mid(A, B, 0, len(A), 0, len(B),
                                    [tuple(p) for p in case["tpts"]], 100,
                                    MODES[case["mode"]])
        assert t == case["trace"]
        assert d == case["diffs"]


def _path(p):
    return [p.abpos, p.aepos, p.bbpos, p.bepos, p.diffs,
            [v for pr in p.trace for v in pr]]


def test_find_extension(gold):
    spec = wr.AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    jspec = jwr.AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    for case in gold["ext"]:
        A, B = _seqs(case)
        p = wr.find_extension(spec, A, B, 0, case["anti"],
                              prefix=bool(case["prefix"]))
        assert _path(p)[:5] + [2 * len(p.trace)] == case["path"]
        assert _path(p)[5] == case["trace"]
        assert _path(p) == _path(jwr.find_extension(
            jspec, A, B, 0, case["anti"], prefix=bool(case["prefix"])))


def test_alignment_cartoon(gold):
    for case in gold["cartoon"]:
        (alen, blen, abpos, aepos, bbpos, bepos, diffs, comp, indent,
         coord) = case["case"]
        texts = []
        for fn in (show.alignment_cartoon, jshow.alignment_cartoon):
            buf = io.StringIO()
            fn(buf, abpos, aepos, bbpos, bepos, alen, blen, diffs,
               bool(comp), indent, coord)
            texts.append(buf.getvalue())
        assert texts == [case["text"]] * 2


def test_flip_alignment(gold):
    for case in gold["flip"]:
        alen, blen, abpos, aepos, bbpos, bepos, comp = case["case"]
        nab, nae, nbb, nbe, nal, nbl, nt = tr.flip_alignment(
            abpos, aepos, bbpos, bepos, alen, blen, bool(comp),
            case["trace"])
        assert [nab, nae, nbb, nbe, nal, nbl] == case["out"]
        assert nt == case["otrace"]


def test_check_trace_points():
    assert tr.check_trace_points(5, 250, 0, 240,
                                 [(3, 95), (4, 100), (2, 45)], 100)
    assert not tr.check_trace_points(5, 250, 0, 241,
                                     [(3, 95), (4, 100), (2, 45)], 100)
    assert not tr.check_trace_points(5, 250, 0, 240, [(3, 95), (4, 145)],
                                     100)
    # tspace == 0: pairs are (a-advance, b-advance)
    assert tr.check_trace_points(0, 50, 0, 40, [(20, 15), (30, 25)], 0)
    assert not tr.check_trace_points(0, 50, 0, 40, [(20, 15), (31, 25)], 0)


def test_wrap_around_alignment(gold):
    spec = wr.AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    jspec = jwr.AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    for case in gold["wrap"]:
        A, B = _seqs(case)
        p = wr.wrap_around_alignment(spec, A, B, -5, 5, case["anti"])
        assert _path(p)[:5] == case["path"]
        assert _path(p)[5] == case["trace"]
        assert _path(p) == _path(jwr.wrap_around_alignment(
            jspec, A, B, -5, 5, case["anti"]))


def test_compute_alignment(gold):
    for case in gold["exact"]:
        A, B = _seqs(case)
        abpos, aepos, bbpos, bepos = case["box"]
        task = case["task"]
        for m in (ex, jexact):
            if task == m.DIFF_ONLY:
                d, _ = m.compute_alignment(A, B, abpos, aepos, bbpos, bepos,
                                           task, 100)
                assert d == case["diffs"]
                continue
            if task in (m.PLUS_ALIGN, m.PLUS_TRACE):
                pd, mid = m.compute_alignment(A, B, abpos, aepos, bbpos,
                                              bepos, m.DIFF_ONLY, 100)
                d, res = m.compute_alignment(A, B, abpos, aepos, bbpos,
                                             bepos, task, 100, mid=mid)
            else:
                d, res = m.compute_alignment(A, B, abpos, aepos, bbpos,
                                             bepos, task, 100)
                assert d == case["diffs"]
            flat = (res if task in (m.PLUS_ALIGN, m.DIFF_ALIGN)
                    else [v for pr in res for v in pr])
            assert flat == case["trace"]


def test_compute_trace_irr(gold):
    for case in gold["irr"]:
        A, B = _seqs(case)
        t, d = tr.compute_trace_irr(A, B, 0, len(A), 0, len(B),
                                    [tuple(p) for p in case["tpts"]],
                                    MODES[case["mode"]])
        assert t == case["trace"]
        assert d == case["diffs"]


def test_transmit_alignment():
    """The same bytes as print_alignment, delivered through the
    callback, and as the JAX package's print_alignment."""
    rng = np.random.default_rng(5)
    A = rng.integers(0, 4, 120).astype(np.uint8)
    B = A.copy()
    B[40] = (B[40] + 1) % 4
    trc, d = tr.compute_trace_pts(A, B, 0, 120, 0, 120, [(2, 100), (1, 20)],
                                  100)
    args = (trc, 0, 120, 0, 120, 0, 100, 10, False, 5, False)
    buf, jbuf = io.StringIO(), io.StringIO()
    show.print_alignment(buf, show.Seq1(A, 0), show.Seq1(B, 0), *args)
    jshow.print_alignment(jbuf, jshow.Seq1(A, 0), jshow.Seq1(B, 0), *args)
    got = []
    show.transmit_alignment(got.append, show.Seq1(A, 0), show.Seq1(B, 0),
                            *args)
    assert "".join(got) == buf.getvalue() == jbuf.getvalue()

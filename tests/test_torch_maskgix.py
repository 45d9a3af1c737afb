"""The masked GIX build on the card (ops/device_pipeline.build_gix_device
with mask intervals) on the CPU, against the port's host build
(io/gix.build_gix) and the JAX package's, column for column: soft masks of
a repeat-rich genome, and hard intervals at a contig's first and last
base, across a contig seam, longer than k, of one base, on contigs
shorter than k and of lengths not a multiple of 4.  Then the index files
written from the card's table, gixmake's `#mask` route, and the
counters that say where each masked table was built.  Every quantity is
an integer; the tolerance is zero."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu.io import gdb as jgdb
from fastga_tpu.io import gix as jgix
from fastga_tpu_torch.cli import gixmake as tgixmake
from fastga_tpu_torch.io import ano as tano
from fastga_tpu_torch.io import gdb as tgdb
from fastga_tpu_torch.io import gix as tgix
from fastga_tpu_torch.ops import device_pipeline as tdp
from fastga_tpu_torch.utils import prof, synth
from tests.test_device_pipeline import _gdb

COLUMNS = ("kbytes", "post", "cont", "comp", "lcp", "maskb", "prefix_index",
           "perm", "post_bytes", "cont_bytes", "seqtot")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counters(monkeypatch):
    """The program's counters, on and empty for the test."""
    monkeypatch.setattr(prof, "ENABLED", True)
    prof.reset()
    yield prof.counters
    prof.reset()


def _random(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, n).astype(np.uint8) for n in lens]


def _repeat_rich():
    """One haplotype of synth.repeat_rich_pair and its soft masks."""
    gen, masks = synth.repeat_rich_pair(np.random.default_rng(11), 90_000,
                                        ncontig=3, copies_per_subfam=4)
    iv = [(c, int(b), int(e)) for c, m in enumerate(masks["A"])
          for b, e in m]
    return gen["A"], iv


def _case(name):
    """(contigs, [(contig, begin, end)]) of one case."""
    if name == "repeat_rich":
        return _repeat_rich()
    if name == "contig_ends":
        # hard #mask intervals on a contig's first and last bases
        return (_random((3001, 2502, 1999), 1),
                [(0, 0, 1), (0, 2990, 3001), (1, 0, 57), (1, 2501, 2502),
                 (2, 0, 1999)])
    if name == "contig_seam":
        # a mask ending contig 0 and one starting contig 1, at every
        # offset of a seam inside a packed byte
        return (_random((2049, 1502, 3003, 777), 2),
                [(0, 1980, 2049), (1, 0, 45), (1, 1490, 1502), (2, 0, 3),
                 (2, 2960, 3003), (3, 0, 777)])
    if name == "long_runs":
        return (_random((5000, 4097), 3),
                [(0, 100, 1100), (0, 1141, 1181), (0, 1182, 1300),
                 (1, 7, 4000), (1, 3000, 3100)])
    if name == "single_bases":
        rng = np.random.default_rng(4)
        starts = rng.choice(3500, 300, replace=False)
        return (_random((3500, 2222), 4),
                [(int(i % 2), int(s), int(s) + 1) for i, s in
                 enumerate(starts) if int(s) < (3500, 2222)[i % 2]])
    if name == "short_contigs":
        # contigs shorter than k among lengths not a multiple of 4; more
        # contigs than the 8 of the padding
        lens = (39, 41, 801, 13, 40, 1203, 66, 5, 2001, 97)
        return (_random(lens, 5),
                [(c, 0, n) for c, n in enumerate(lens) if c % 3 == 0]
                + [(2, 17, 30), (5, 600, 1203), (8, 1950, 2001)])
    raise ValueError(name)


CASES = ("repeat_rich", "contig_ends", "contig_seam", "long_runs",
         "single_bases", "short_contigs")


def _both(name):
    contigs, iv = _case(name)
    g, _ = synth.to_gdb("g", contigs)
    return g, contigs, iv


@pytest.mark.parametrize("case", CASES)
def test_masked_device_build_matches_host_and_jax(case, counters):
    """build_gix_device with masks equals io.gix.build_gix and the JAX
    package's build_gix column for column, and counts one card table."""
    g, contigs, iv = _both(case)
    masks = [tgdb.MaskIval(*m) for m in iv]
    dev = tdp.build_gix_device(g, "cpu", masks=masks)
    assert counters().get("gix.card_tables") == 1
    assert counters().get("gix.entries") == dev.n
    assert "gix.host_tables" not in counters()
    host = tgix.build_gix(g, masks=masks)
    jt = jgix.build_gix(_gdb(contigs),
                        masks=[jgdb.MaskIval(*m) for m in iv])
    assert counters().get("gix.host_tables") == 1
    assert host.n > 0 and host.maskb.any()
    for f in COLUMNS:
        a, b = np.asarray(getattr(host, f)), np.asarray(getattr(dev, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert np.array_equal(np.asarray(getattr(jt, f)), b), f


@pytest.mark.parametrize("masks", [None, []], ids=["none", "empty"])
def test_unmasked_device_build_is_unchanged(masks, counters):
    """Without mask intervals the card's build is the unmasked one: the
    host's table with zero mask bytes, no masked span or counter."""
    g, contigs, _ = _both("short_contigs")
    dev = tdp.build_gix_device(g, "cpu", masks=masks)
    assert {e[3] for e in prof.events()} == {"devpipe.gix"}
    assert not counters()
    host = tgix.build_gix(g)
    assert not dev.maskb.any()
    for f in COLUMNS:
        a, b = np.asarray(getattr(host, f)), np.asarray(getattr(dev, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _gix_files(root):
    stub, parts = tgix.gix_paths(root)
    files = [stub] + sorted(parts.parent.glob(parts.name + "*"))
    return {f.name: f.read_bytes() for f in files}


@pytest.mark.parametrize("case", ["repeat_rich", "contig_seam"])
def test_masked_device_table_writes_the_host_files(case, tmp_path):
    """write_gix of the card's masked table gives the host table's .gix
    stub and part files byte for byte."""
    g, _, iv = _both(case)
    masks = [tgdb.MaskIval(*m) for m in iv]
    for d, t in (("d", tdp.build_gix_device(g, "cpu", masks=masks)),
                 ("h", tgix.build_gix(g, masks=masks))):
        (tmp_path / d).mkdir()
        tgix.write_gix(t, tmp_path / d / "G")
    assert (_gix_files(tmp_path / "d" / "G")
            == _gix_files(tmp_path / "h" / "G"))


@pytest.mark.parametrize("cap", ["card", "host"])
def test_gixmake_mask_route(cap, tmp_path, monkeypatch, counters, capsys):
    """gixmake with a #mask builds the masked index on the card, and on
    the host past a lowered single-shot cap with the decline on stderr;
    both write the host build's files."""
    contigs, iv = _case("contig_seam")
    g, _ = synth.to_gdb("G", contigs)
    tgdb.write_gdb(g, tmp_path / "G")
    masks = [tgdb.MaskIval(*m) for m in iv]
    tano.write_ano(tmp_path / "m.1ano", g, masks)
    if cap == "host":
        monkeypatch.setattr(tdp, "_MAX_DEV_BASES", 1000)
    assert tgixmake.main([str(tmp_path / "G.1gdb"), f"#{tmp_path}/m.1ano"],
                         device="cpu") == 0
    c = counters()
    assert (c.get("gix.card_tables"), c.get("gix.host_tables")) == \
        {"card": (1, None), "host": (None, 1)}[cap]
    declined = "device GIX build declined" in capsys.readouterr().err
    assert declined == (cap == "host")
    (tmp_path / "h").mkdir()
    tgix.write_gix(tgix.build_gix(tgdb.read_gdb(tmp_path / "G"),
                                  masks=masks), tmp_path / "h" / "G")
    assert _gix_files(tmp_path / "G") == _gix_files(tmp_path / "h" / "G")

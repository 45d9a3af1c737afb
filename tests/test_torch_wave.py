"""The port's plain wave kernels against the JAX package's twins, exactly
(tolerance 0: the recurrence is integer arithmetic).

- the plain stepper against ops/wave.py build_forward_chunk (XLA), both
  directions, 3 chunks, slot space (all 18 state entries, choice and band
  logs), on three kinds of pair: 10% mutated; a 12 kb exact copy that one
  wave's snake runs through (past the CUDA stepper's 8,192-base sequence
  window); tubes anchored within 64 bases of a sequence's start or end;
- plain wave-0 against host_wave0;
- the plain walk against a scalar walk, on a random log and on the logs
  the plain stepper wrote;
- canon_state: per-tube and batch-wide recentering give one form;
- the pool-tail fetch case.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu.ops import seqpack as jseqpack, wave as jwave
from fastga_tpu.ops.wave_ref import AlignSpec as JAlignSpec
from fastga_tpu_torch import convert
from fastga_tpu_torch.ops import wave_kernels as wk
from fastga_tpu_torch.ops.wave_ref import AlignSpec
from tests.test_wave_pallas import _mutate

NAMES = ("V Thi Tlo M kbase low hgh besta bestx lasta trima trimx trimd "
         "trim_wave trim_slot alive fallback dif").split()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair_pool(seed, n=30000, rate=0.10):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 4, n).astype(np.uint8)
    B = _mutate(A, rate, rng)
    return jseqpack.SeqPool.build({"a": A, "b": B})


def _targs(pool, n):
    aw, alen = pool.offs["a"]
    bw, blen = pool.offs["b"]

    def col(v):
        return np.full(n, v, np.int32)
    return (col(aw), col(alen), col(bw), col(blen), col(-(1 << 30)),
            col(1 << 30))


def _assert_state(ref, got, where):
    for i, (a, b) in enumerate(zip(ref, got)):
        a, b = np.asarray(a), np.asarray(b)
        if i in (1, 2):
            a, b = a.view(np.uint32), b.view(np.uint32)
        assert np.array_equal(a, b), f"{where}: {NAMES[i]}"


def _kind_pool(kind, n, seed=7):
    """(pool, anti) for the stepper tests.  ``mutated``: 30 kb, 10% mutated
    with indels.  ``exact``: B is A with 10% substitutions outside
    [8,000, 20,000), an exact copy inside; half the tubes are anchored just
    before that stretch, half just after, so in either direction a wave's
    snake runs through 12 kb.  ``ends``: 4 kb with 10% substitutions, tubes
    anchored within 64 bases of the sequences' start or end."""
    if kind == "mutated":
        anti = [2 * (8000 + 137 * i) for i in range(n)]
        return _pair_pool(seed), np.asarray(anti, np.int32)
    rng = np.random.default_rng(seed)
    L = 30000 if kind == "exact" else 4000
    A = rng.integers(0, 4, L).astype(np.uint8)
    B = A.copy()
    sub = rng.random(L) < 0.10
    if kind == "exact":
        sub[8000:20000] = False
    B[sub] = (B[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    i = np.arange(n)
    if kind == "exact":
        x0 = np.where(i % 2 == 0, 7700 + 7 * i, 20300 - 7 * i)
    else:
        x0 = np.where(i % 2 == 0, 10 + 3 * (i // 2), L - 10 - 3 * (i // 2))
    return (jseqpack.SeqPool.build({"a": A, "b": B}),
            (2 * x0).astype(np.int32))


@pytest.mark.parametrize("kind,direction", [
    pytest.param("mutated", +1, id="1"),
    pytest.param("mutated", -1, id="-1"),
    pytest.param("exact", +1, id="exact+1"),
    pytest.param("exact", -1, id="exact-1"),
    pytest.param("ends", +1, id="ends+1"),
    pytest.param("ends", -1, id="ends-1")])
def test_plain_chunk_matches_xla(kind, direction):
    import jax.numpy as jnp
    spec = JAlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    tspec = AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    cfg = jwave.WaveConfig(n=32, w=256, chunk=24, max_chunks=64)
    n = cfg.n
    pool, anti = _kind_pool(kind, n)
    targs = _targs(pool, n)
    w0 = jwave.build_wave0(cfg, direction)
    xla_chunk, _ = jwave.build_forward_chunk(
        cfg, spec.ave_path, np.asarray(spec.table), np.asarray(spec.score),
        direction)
    pw = jnp.asarray(pool.words)
    jt = tuple(jnp.asarray(t) for t in targs)
    stx, _ = w0(pw, jt, jnp.asarray(np.full(n, -20, np.int32)),
                jnp.asarray(np.full(n, 20, np.int32)), jnp.asarray(anti))
    stx_np = [np.asarray(s) for s in stx]
    tpool = convert.pool_from_numpy(pool.words, "cpu")
    tt = convert.targs_from_numpy(targs, "cpu")
    stt = convert.state_from_numpy(stx_np, "cpu")
    for ch in range(3):
        stx, cx, bx = xla_chunk(pw, jt, stx)
        stt, ct, bt = wk.chunk_plain(tpool, tt, stt, tspec, direction,
                                     cfg.chunk)
        _assert_state([np.asarray(s) for s in stx], convert.state_to_numpy(
            stt), f"chunk {ch}")
        assert np.array_equal(np.asarray(cx), ct.numpy()), f"chunk {ch} ch"
        assert np.array_equal(np.asarray(bx), bt.numpy()), f"chunk {ch} band"
    # the wrapper routes CPU tensors to the plain stepper
    assert wk.LAUNCHES["wave_chunk"] == 0


@pytest.mark.parametrize("direction", [+1, -1])
def test_plain_wave0_matches_host(direction):
    pool = _pair_pool(11, rate=0.08)
    cfg = jwave.WaveConfig(n=32, w=256, chunk=24, max_chunks=64)
    n = cfg.n
    targs = _targs(pool, n)
    anti = np.asarray([2 * (6000 + 211 * i) for i in range(n)], np.int32)
    dgmin = np.full(n, -25, np.int32)
    dgmax = np.full(n, 25, np.int32)
    valid = np.ones(n, np.int32)
    valid[-3:] = 0   # padding rows come out dead
    st_host, _ = jwave.host_wave0(pool.words, targs, dgmin, dgmax, anti,
                                  cfg, direction)
    got = wk.wave0(convert.pool_from_numpy(pool.words, "cpu"),
                   convert.targs_from_numpy(targs, "cpu"),
                   torch.as_tensor(dgmin), torch.as_tensor(dgmax),
                   torch.as_tensor(anti), torch.as_tensor(valid), cfg.w,
                   direction)
    got = convert.state_to_numpy(got)
    v = valid > 0
    alive = st_host[15] & v
    assert np.array_equal(alive, got[15])
    for i in range(18):
        if i == 15:
            continue
        a, b = np.asarray(st_host[i]), np.asarray(got[i])
        assert np.array_equal(a[v], b[v]), NAMES[i]
    # padding rows: dead, no fallback, nothing in band
    assert not got[16].any()
    assert (got[0][~v] == (-1 if direction > 0 else 0x7FFFFFFF)).all()


def _scalar_walk(ch, kb, trim_diag, trim_wave):
    G, N, W = ch.shape
    D = np.zeros((G + 1, N), np.int32)
    diag = trim_diag.copy()
    for w in range(G - 1, -1, -1):
        D[w + 1] = diag
        for t in range(N):
            if w + 1 <= trim_wave[t]:
                slot = min(max(diag[t] - kb[w, t], 0), W - 1)
                cc = ch[w, t, slot]
                if cc == wk.CH_LOW:
                    diag[t] -= 1
                elif cc == wk.CH_HIGH:
                    diag[t] += 1
    D[0] = diag
    return D


def _check_walk(ch, kb, trim_diag, trim_wave):
    D_ref = _scalar_walk(ch, kb, trim_diag, trim_wave)
    d0, D = wk.backtrack_walk(torch.as_tensor(ch), torch.as_tensor(kb),
                              torch.as_tensor(trim_diag),
                              torch.as_tensor(trim_wave))
    assert np.array_equal(d0.numpy(), D_ref[0])
    assert np.array_equal(D.numpy(), D_ref[1:])


def test_plain_walk_matches_scalar():
    rng = np.random.default_rng(3)
    G, N, W = 48, 32, 256
    ch = rng.integers(0, 4, (G, N, W)).astype(np.uint8)
    kb = rng.integers(-40, 40, (G, N)).astype(np.int32)
    trim_diag = rng.integers(-100, 100, N).astype(np.int32)
    trim_wave = rng.integers(0, G + 1, N).astype(np.int32)
    _check_walk(ch, kb, trim_diag, trim_wave)


@pytest.mark.parametrize("direction", [+1, -1])
def test_plain_walk_matches_scalar_on_chunk_logs(direction):
    """The walk over the choice and kbase logs the plain stepper wrote,
    from the state's trim diagonal and trim wave (the wave program's
    inputs), against the scalar walk."""
    pool = _pair_pool(13)
    spec = AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    n, W, G = 32, 256, 48
    tpool = convert.pool_from_numpy(pool.words, "cpu")
    tt = convert.targs_from_numpy(_targs(pool, n), "cpu")
    anti = torch.as_tensor([2 * (9000 + 173 * i) for i in range(n)],
                           dtype=torch.int32)
    dg = torch.full((n,), -20, dtype=torch.int32)
    st = wk.wave0(tpool, tt, dg, -dg, anti, torch.ones(n, dtype=torch.int32),
                  W, direction)
    st, ch, band = wk.chunk_plain(tpool, tt, st, spec, direction, G)
    assert int(st[13].min()) > 0     # every tube trimmed past wave 0
    _check_walk(ch.numpy(), band[:, :, 2].contiguous().numpy(),
                st[14].numpy(), st[13].numpy())


def _recenter_per_tube(st, W):
    """Per-tube gated recentering, as the CUDA stepper does it: only tubes
    near a slot edge shift."""
    st = list(st)
    V, Thi, Tlo, M = st[:4]
    kbase, low, hgh, alive = st[4], st[5], st[6], st[15]
    need = alive & ((low <= 2) | (hgh >= W - 3))
    shift = torch.where(need, ((low + hgh) >> 1) - W // 2, 0)
    wix = torch.arange(W)[None, :]
    src = wix + shift[:, None]
    inside = (src >= 0) & (src < W)
    srcc = src.clamp(0, W - 1)
    fills = (-1, 0, 0, 0)
    for j in range(4):
        st[j] = torch.where(inside, torch.gather(st[j], 1, srcc),
                            torch.full_like(st[j], fills[j]))
    st[4] = kbase + shift
    st[5] = low - shift
    st[6] = hgh - shift
    return tuple(st)


def test_canon_state_maps_recenterings_together():
    """A batch-recentered state and the same state recentered per tube
    (different slots and kbase) have one canonical form; so do their
    logs when rows are shifted by the kbase difference."""
    pool = _pair_pool(5)
    spec = AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    n, W = 8, 256
    targs = _targs(pool, n)
    tpool = convert.pool_from_numpy(pool.words, "cpu")
    tt = convert.targs_from_numpy(targs, "cpu")
    anti = torch.as_tensor([2 * (5000 + 301 * i) for i in range(n)],
                           dtype=torch.int32)
    # a band hugging the low slot edge forces a recenter in wave 1
    dg = torch.full((n,), -20, dtype=torch.int32)
    st = wk.wave0(tpool, tt, dg, -dg, anti, torch.ones(n, dtype=torch.int32),
                  W, +1)
    st, ch, band = wk.chunk_plain(tpool, tt, st, spec, +1, 12)
    kb = band[:, :, 2]
    # shift half the tubes by a different slot offset: same diagonals
    shifted = list(st)
    off = torch.tensor([0, 5, -7, 3, 0, 11, -2, 1], dtype=torch.int32)
    wix = torch.arange(W)[None, :]
    src = wix - off[:, None]
    inside = (src >= 0) & (src < W)
    for j, fill in zip(range(4), (-1, 0, 0, 0)):
        shifted[j] = torch.where(inside, torch.gather(
            st[j], 1, src.clamp(0, W - 1)), torch.full_like(st[j], fill))
    shifted[4] = st[4] - off
    shifted[5] = st[5] + off
    shifted[6] = st[6] + off
    src3 = wix[None] - off[None, :, None]
    ch2 = torch.where((src3 >= 0) & (src3 < W), torch.gather(
        ch, 2, src3.clamp(0, W - 1).expand_as(ch)),
        torch.full_like(ch, wk.CH_NONE))
    kb2 = kb - off[None, :]
    a = wk.canon_state(st, (ch, kb), W)
    b = wk.canon_state(tuple(shifted), (ch2, kb2), W)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    # and the per-tube recenter helper gives the same canonical state
    c = wk.canon_state(_recenter_per_tube(st, W), None, W)
    for k in c:
        assert np.array_equal(a[k], c[k]), k


def test_pool_tail_fetch_exact():
    """Words past the pool end clamp to the last word, exactly as the host
    fetch mirror (_np_fetch64) does."""
    rng = np.random.default_rng(9)
    words = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    starts = np.array([0, 3, 17, 16 * 58 + 5, 16 * 60 + 9, 16 * 63 + 1,
                       16 * 64 + 2, -3], np.int32)
    woff = np.full(len(starts), 0, np.int32)
    ref = jwave._np_fetch64(words, woff, starts)
    got = wk._fetch64(wk._u32(convert.pool_from_numpy(words, "cpu")),
                      torch.as_tensor(woff, dtype=torch.int64),
                      torch.as_tensor(starts, dtype=torch.int64))
    for r, g in zip(ref, got):
        assert np.array_equal(r.astype(np.int64), g.numpy())

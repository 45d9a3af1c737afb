# Copied from fastga_tpu/ops/syncmer.py; imports point at fastga_tpu_torch;
# syncmer_mask is the port of its syncmer_mask_jnp.
"""(12,8)-closed-syncmer selection — the GIX sampling rule, as vector ops.

Semantics derived from the reference's rolling automaton (scan_thread
GIXmake.c:406-611): position j (0-based, in contig coordinates) is selected
iff, over the 5 canonical 8-mer hashes v[j..j+4] inside the 12-mer starting
at j, the window minimum occurs at the first (v[j] == min) or last
(v[j+4] == min) window slot (ties included at both ends — the automaton's
Hit R / Hit L / Hit RE cases).

The canonical 8-mer hash at position p is
    min( TMAP[n4[p]]<<8 | TMAP[n4[p+4]],
         TMAP[COMP[n4[p+4]]]<<8 | TMAP[COMP[n4[p]]] )
with n4[p] the big-endian packed 4-mer at p (GIXmake.c:460-540).

A selected j yields a forward index entry (40-mer starting at j, post=j) when
j <= len-40, and a reverse-complement entry (40-mer ending at j+11, post=j+12,
per setup_thread_plain GIXmake.c:925-941) when j >= 28.

Both a numpy implementation (host bulk builds) and a tensor version
(``syncmer_mask``, on any torch device) are provided; they are
semantically identical.
"""

from __future__ import annotations

import numpy as np

from .constants import COMP, KMER, SMER, SOFF, TMAP, TMER


def pack4(bases: np.ndarray) -> np.ndarray:
    """n4[i] = big-endian packed 4-mer code of bases[i..i+3]; len = n-3."""
    b = bases.astype(np.uint16)
    return ((b[:-3] << 6) | (b[1:-2] << 4) | (b[2:-1] << 2) | b[3:]
            ).astype(np.uint8)


def smer_hash(n4: np.ndarray) -> np.ndarray:
    """Canonical 8-mer hash v[p] for p in [0, len(n4)-4)."""
    tf = TMAP[n4].astype(np.uint16)
    tc = TMAP[COMP[n4]].astype(np.uint16)
    fwd = (tf[:-4] << 8) | tf[4:]
    rev = (tc[4:] << 8) | tc[:-4]
    return np.minimum(fwd, rev)


def syncmer_positions(bases: np.ndarray) -> np.ndarray:
    """All 12-mer start positions j that are closed syncmers (numpy)."""
    n = len(bases)
    if n < TMER:
        return np.zeros(0, dtype=np.int64)
    n4 = pack4(bases)            # positions 0..n-4
    v = smer_hash(n4)            # positions 0..n-8
    nv = len(v)                  # = n-7
    nw = nv - SOFF               # windows j in [0, n-11)
    if nw <= 0:
        return np.zeros(0, dtype=np.int64)
    m = v[:nw].copy()
    for k in range(1, SOFF + 1):
        np.minimum(m, v[k : k + nw], out=m)
    sel = (v[:nw] == m) | (v[SOFF : SOFF + nw] == m)
    return np.flatnonzero(sel)


def index_entries(bases: np.ndarray, kmer: int = KMER
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(forward posts, reverse-complement posts) of index entries for one
    contig. Forward post = 40-mer start j; RC post = j + TMER (the exclusive
    end of the RC 40-mer that *ends* at j+TMER-1)."""
    pos = syncmer_positions(bases)
    n = len(bases)
    fwd = pos[pos <= n - kmer]
    rc = pos[pos >= kmer - TMER] + TMER
    return fwd, rc


# -- tensor version ----------------------------------------------------------

def syncmer_mask(bases, length):
    """Bool tensor over positions [0, N-11) marking closed syncmers, on the
    device of ``bases`` (int32/uint8 tensor of shape (N,), padded);
    ``length``: the actual length.  Positions >= length-TMER+1 are masked
    False."""
    import torch

    dev = bases.device
    tmap = torch.as_tensor(TMAP.astype(np.int64), device=dev)
    comp = torch.as_tensor(COMP.astype(np.int64), device=dev)
    b = bases.to(torch.int64)
    n = b.shape[0]
    n4 = ((b[: n - 3] << 6) | (b[1 : n - 2] << 4)
          | (b[2 : n - 1] << 2) | b[3:])
    tf = tmap[n4]
    tc = tmap[comp[n4]]
    nv = n4.shape[0] - 4
    fwd = (tf[:nv] << 8) | tf[4 : 4 + nv]
    rev = (tc[4 : 4 + nv] << 8) | tc[:nv]
    v = torch.minimum(fwd, rev)
    nw = nv - SOFF
    m = v[:nw]
    for k in range(1, SOFF + 1):
        m = torch.minimum(m, v[k : k + nw])
    sel = (v[:nw] == m) | (v[SOFF : SOFF + nw] == m)
    j = torch.arange(nw, device=dev)
    return sel & (j <= length - TMER)



"""Unit-cost edit distance (mismatch, insertion, deletion: 1 each) between
many pairs of pieces at once, in plain PyTorch.

Every piece is a stretch of a flat sequence (``seq[start:start + len]``,
base codes 0-3).  Rows run over the first piece; within a row the
horizontal step is a running minimum: D[i][j] = j + min over k <= j of
(T[k] - k), where T holds the vertical and diagonal candidates.
``panels`` computes the whole matrix of short pieces (a trace panel);
``banded`` follows the straight line from corner to corner within ``half``
cells of it, for whole records.  A banded value is the cost of a real
alignment, so it is never below the true distance; it equals it where the
best path stays inside the band.
"""

from __future__ import annotations

import torch

def _take(seq, pos):
    return seq[pos.clamp(min=0, max=seq.shape[0] - 1)]


def panels(seq_a, start_a, la, seq_b, start_b, lb, block=1 << 17):
    """The edit distance of each seq_a[start_a:+la] and
    seq_b[start_b:+lb] (all [n] tensors on the sequences' device),
    int64 [n]."""
    out = []
    for s in range(0, start_a.shape[0], block):
        sl = slice(s, s + block)
        out.append(_panels(seq_a, start_a[sl], la[sl], seq_b, start_b[sl],
                           lb[sl]))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=seq_a.device)
    return torch.cat(out)


def _panels(seq_a, start_a, la, seq_b, start_b, lb):
    n = start_a.shape[0]
    dev = seq_a.device
    La, Lb = int(la.max()), int(lb.max())
    idx = torch.arange(Lb + 1, dtype=torch.int32, device=dev)
    b = _take(seq_b, start_b[:, None] + idx[None, :-1].long())
    D = idx.expand(n, Lb + 1).clone()
    T = torch.empty_like(D)
    for i in range(1, La + 1):
        ai = _take(seq_a, start_a + (i - 1))
        cost = (ai[:, None] != b).to(torch.int32)
        T[:, 0] = i
        torch.minimum(D[:, 1:] + 1, D[:, :-1] + cost, out=T[:, 1:])
        Dn = torch.cummin(T - idx, dim=1).values + idx
        D = torch.where((la >= i)[:, None], Dn, D)
    return D.gather(1, lb.long()[:, None])[:, 0].long()


def banded(seq_a, start_a, la, seq_b, start_b, lb, half=64):
    """The cost of the best alignment of each seq_a[start_a:+la] and
    seq_b[start_b:+lb] whose path keeps within ``half`` diagonals of the
    main one (j - i in [-half, half]), int64 [n]; -1 where lb - la itself
    lies outside that band."""
    n = start_a.shape[0]
    dev = seq_a.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    la, lb = la.long(), lb.long()
    W = 2 * half + 1
    La = int(la.max())
    big = 1 << 29
    u = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    rows = torch.arange(La, device=dev)[None, :]
    a_all = _take(seq_a, start_a.long()[:, None] + rows)
    # b_all[:, i + u] is B's base of column j = i + u - half (j >= 1)
    xs = torch.arange(La + W, device=dev)[None, :]
    b_all = _take(seq_b, start_b.long()[:, None] + xs - half - 1)
    D = torch.where(u >= half, u - half, big).expand(n, W).contiguous()
    T = torch.empty_like(D)
    k = lb - la + half
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ok = (k >= 0) & (k < W)
    # the records whose last row is i, taken as each row is reached
    la_h = la.cpu()
    ends = {}
    for r in torch.nonzero(ok.cpu())[:, 0].tolist():
        ends.setdefault(int(la_h[r]), []).append(r)
    ends = {i: torch.tensor(v, device=dev) for i, v in ends.items()}
    for i in range(1, La + 1):
        cost = (a_all[:, i - 1:i] != b_all[:, i:i + W]).to(torch.int32)
        torch.add(D, cost, out=T)
        torch.minimum(T[:, :-1], D[:, 1:] + 1, out=T[:, :-1])
        if i <= half:                       # column 0 and the cells left
            T[:, :half - i] = big
            T[:, half - i] = i
        D = torch.cummin(T - u, dim=1).values + u
        if i in ends:
            r = ends[i]
            out[r] = D[r, k[r]].long()
    return out

# Copied from fastga_tpu/ops/chainfilter.py; imports point at fastga_tpu_torch.
"""ALNchain's chain-and-filter engine (ALNchain.c:78-636).

Chains alignments per (B-scaffold, strand) group toward a 1-to-1 global
alignment allowing rearrangements:

1. KD-tree over (aepos, bepos) built by exact median quickselect
   (buildKDTree ALNchain.c:204-219); nodes processed in (bread, abpos)
   order relax their best predecessor with score
   ext - gap*penGap - ovl*penOvl (KDRangeChain 336-380).  The tree
   structure is replicated exactly (median-of-medians pivot) because
   equal-score ties resolve by traversal order.
2. Best-first chain extraction with score-drop termination
   (backtrackLocal/popLocalChain 388-489), min chain score/fragments.
3. Cross-chain novel-coverage filter per B-scaffold with fuzzy range
   merging (filterChain 518-636).

Coordinates are scaffold-space; complemented records use
reverse-complemented B-scaffold coordinates.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List, Optional

INTERNAL = 1
HEAD = 2


@dataclass
class Node:
    bread: int          # (bscaf << 1) | comp
    abpos: int
    aepos: int
    bbpos: int
    bepos: int
    which: int          # original record index
    next: Optional["Node"] = None
    L: Optional["Node"] = None
    R: Optional["Node"] = None
    clen: int = 1
    active: int = 0
    score: float = 0.0

    def aln_size(self) -> float:
        return (self.aepos - self.abpos) + (self.bepos - self.bbpos)


def _bpos(n: Node, axis: int) -> int:
    return n.abpos if axis == 0 else n.bbpos


def _epos(n: Node, axis: int) -> int:
    return n.aepos if axis == 0 else n.bepos


# -- exact replication of the reference's quickselect/kd-build ---------------


def _partition5(nodes, order, low, high, axis):
    for i in range(low + 1, high + 1):
        k = order[i]
        p = _epos(nodes[k], axis)
        j = i - 1
        while j >= low and _epos(nodes[order[j]], axis) > p:
            order[j + 1] = order[j]
            j -= 1
        order[j + 1] = k
    return (low + high) // 2


def _partition(nodes, order, low, high, k, axis):
    p = _epos(nodes[order[k]], axis)
    order[k], order[high] = order[high], order[k]
    i = low
    for j in range(low, high):
        if _epos(nodes[order[j]], axis) <= p:
            order[i], order[j] = order[j], order[i]
            i += 1
    order[i], order[high] = order[high], order[i]
    return i


def _select_pivot(nodes, order, low, high, axis):
    if high - low < 5:
        return _partition5(nodes, order, low, high, axis)
    n = (high - low + 5) // 5
    i = 0
    for l in range(low, high + 1, 5):
        h = min(l + 4, high)
        m = _partition5(nodes, order, l, h, axis)
        order[low + i], order[m] = order[m], order[low + i]
        i += 1
    return _quick_select(nodes, order, low, low + n - 1, low + n // 2, axis)


def _quick_select(nodes, order, low, high, k, axis):
    while True:
        i = _select_pivot(nodes, order, low, high, axis)
        i = _partition(nodes, order, low, high, i, axis)
        if i == k:
            return k
        if i > k:
            high = i - 1
        else:
            low = i + 1


def build_kdtree(nodes, order, low, high, depth) -> Optional[Node]:
    if low > high:
        return None
    i = (low + high) >> 1
    _quick_select(nodes, order, low, high, i, depth & 1)
    root = nodes[order[i]]
    root.L = build_kdtree(nodes, order, low, i - 1, depth + 1)
    root.R = build_kdtree(nodes, order, i + 1, high, depth + 1)
    return root


# -- chaining -----------------------------------------------------------------


def _kd_range_chain(root, query, max_gap, max_ovl, pen_gap, pen_ovl, depth):
    if root is None or query is None:
        return
    axis = depth & 1
    rpos = _epos(root, axis)
    qpos = _bpos(query, axis)
    g0 = query.abpos - root.aepos
    g1 = query.bbpos - root.bepos
    o0 = o1 = 0
    if g0 < 0:
        o0, g0 = -g0, 0
    if g1 < 0:
        o1, g1 = -g1, 0
    e0 = query.aepos - (query.abpos if g0 > 0 else root.aepos)
    e1 = query.bepos - (query.bbpos if g1 > 0 else root.bepos)

    if (root.active and root is not query and e0 > 0 and e1 > 0
            and g0 <= max_gap and g1 <= max_gap
            and o0 <= max_ovl and o1 <= max_ovl
            and o0 < query.aepos - query.abpos
            and o1 < query.bepos - query.bbpos):
        score = (e0 + e1 - g0 * pen_gap - g1 * pen_gap
                 - o0 * pen_ovl - o1 * pen_ovl)
        if root.score + score > query.score:
            query.next = root
            query.clen = root.clen + 1
            query.score = root.score + score

    big = max_ovl == 0x7FFFFFFF
    if big or qpos - max_ovl <= rpos:
        _kd_range_chain(root.L, query, max_gap, max_ovl, pen_gap, pen_ovl,
                        depth + 1)
    if big or qpos + max_gap >= rpos:
        _kd_range_chain(root.R, query, max_gap, max_ovl, pen_gap, pen_ovl,
                        depth + 1)


def _backtrack_local(node, max_drop, pen_gap, pen_ovl):
    if node.active:
        return
    head = node
    min_score = node.score
    head.active = HEAD
    nxt = node.next
    while nxt:
        if nxt.active or nxt.score > max_drop + min_score:
            node.next = None
            break
        if nxt.score < min_score:
            min_score = nxt.score
        nxt.active = INTERNAL
        node = nxt
        nxt = node.next

    # recalculate chain score
    node = head
    score = node.aln_size()
    nxt = node.next
    clen = 1
    while nxt:
        g0 = node.abpos - nxt.aepos
        g1 = node.bbpos - nxt.bepos
        o0 = o1 = 0
        if g0 < 0:
            o0, g0 = -g0, 0
        if g1 < 0:
            o1, g1 = -g1, 0
        e0 = (nxt.aepos if g0 > 0 else node.abpos) - nxt.abpos
        e1 = (nxt.bepos if g1 > 0 else node.bbpos) - nxt.bbpos
        score += (e0 + e1 - g0 * pen_gap - g1 * pen_gap
                  - o0 * pen_ovl - o1 * pen_ovl)
        node = nxt
        nxt = node.next
        clen += 1
    head.score = score
    head.clen = clen


def local_chain(nodes: List[Node], max_gap, max_ovl, pen_gap, pen_ovl,
                max_drop, min_frag, min_score) -> int:
    """Chain one (bscaf, strand) group in place; returns # chains."""
    acnt = len(nodes)
    order = list(range(acnt))
    root = build_kdtree(nodes, order, 0, acnt - 1, 0)
    for node in nodes:
        _kd_range_chain(root, node, max_gap, max_ovl, pen_gap, pen_ovl, 0)
        node.active = INTERNAL

    # pop chains best-first (stable sort descending by score)
    for n in nodes:
        n.active = 0
    for n in sorted(nodes, key=lambda x: -x.score):
        _backtrack_local(n, max_drop, pen_gap, pen_ovl)

    nchain = 0
    ms2 = min_score * 2   # chain score counts both X and Y
    for n in nodes:
        if n.active != HEAD:
            continue
        if n.score < ms2 or n.clen < min_frag:
            n.active = 1
            continue
        nchain += 1
    return nchain


# -- coverage filter ----------------------------------------------------------


def _merge_fuzzy(ranges, fz, presorted=False):
    if not ranges:
        return []
    if not presorted:
        ranges = sorted(ranges)
    out = [list(ranges[0])]
    for b, e in ranges[1:]:
        if b <= out[-1][1] + fz:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([b, e])
    return [tuple(r) for r in out]


def _sorted_overlap(ranges):
    ovl = 0
    end = ranges[0][1]
    for b, e in ranges[1:]:
        if b <= end:
            if e > end:
                ovl += end - b
                end = e
            else:
                ovl += e - b
        else:
            end = e
    return ovl


def filter_chains(nodes: List[Node], alen: int, blen_of, max_cov, min_ext,
                  fz_merge) -> int:
    """Cross-chain novel-coverage filter over one B-scaffold group
    (filterChain ALNchain.c:518-636); blen_of(bread>>1) -> scaffold len."""
    heads = [n for n in nodes if n.active == HEAD]
    if not heads:
        return 0
    heads.sort(key=lambda x: -x.score)

    def chain_ranges(head):
        xr, yr = [], []
        node = head
        while node:
            xr.append((node.abpos, node.aepos))
            yr.append((node.bbpos, node.bepos))
            node = node.next
        if head.bread & 1:
            blen = blen_of(head.bread >> 1)
            yr = [(blen - e, blen - b) for b, e in yr]
        return xr, yr

    xr0, yr0 = chain_ranges(heads[0])
    xm = _merge_fuzzy(xr0, fz_merge)
    ym = _merge_fuzzy(yr0, fz_merge)
    xext = alen * min_ext
    yext = blen_of(heads[0].bread >> 1) * min_ext

    nfilter = 0
    for head in heads[1:]:
        xr, yr = chain_ranges(head)
        xr = _merge_fuzzy(xr, 0)
        yr = _merge_fuzzy(yr, 0)
        xlen = sum(e - b for b, e in xr)
        ylen = sum(e - b for b, e in yr)
        xall = sorted(xr + xm)
        yall = sorted(yr + ym)
        xcov = _sorted_overlap(xall)
        ycov = _sorted_overlap(yall)
        xnew = _merge_fuzzy(xall, fz_merge, presorted=True)
        ynew = _merge_fuzzy(yall, fz_merge, presorted=True)
        if ((xcov > xlen * max_cov and ycov > ylen * max_cov)
                or (xlen - xcov < xext and ylen - ycov < yext)):
            head.active = INTERNAL
            nfilter += 1
        else:
            xm, ym = xnew, ynew
    return nfilter

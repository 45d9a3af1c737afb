"""Merge of two ascending int64 streams: the CUDA kernel
(csrc/merge_path.cu) beside its plain PyTorch version.

Port of fastga_tpu/ops/merge_pallas.py merge_sorted_streams.
``merge_sorted_streams(opsA, opsB)`` takes two tuples of int64 columns of
E1 and E2 rows (any sizes), the first two columns being the lexicographic
keys (k1, k2), each stream ascending with its +MAX invalid rows at the tail;
it returns the E1 + E2 rows of both in ascending (k1, k2) order with the
other columns riding along.  Ties go to A first, so the result is the
stable sort of concat(A, B) on every row; for unique live keys it equals
``jax.lax.sort(concat, num_keys=2)`` on the live rows.

The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors, at every size; ``LAUNCHES["merge_path"]`` counts
launches.
"""

from __future__ import annotations

import torch

from .cuda_build import (LAUNCHES, build_kernels, check, ptr, ptr_array,
                         raise_on, stream)

MERGE_TILE = 2048      # outputs per CTA tile (csrc/merge_path.cu MTILE)
MAX_COLS = 8


def lexsort2(k1, k2):
    """Permutation that sorts rows by (k1, k2), stable: a stable sort by
    k2, then a stable sort of the gathered k1."""
    o = torch.sort(k2, stable=True).indices
    return o[torch.sort(k1[o], stable=True).indices]


def _check_cols(opsA, opsB):
    if len(opsA) != len(opsB) or not 2 <= len(opsA) <= MAX_COLS:
        raise ValueError(f"merge_sorted_streams: {len(opsA)} and "
                         f"{len(opsB)} columns (2 to {MAX_COLS}, equal)")


def merge_plain(opsA, opsB):
    """Stable lexicographic sort of concat(A, B) by the first two
    columns."""
    _check_cols(opsA, opsB)
    cols = [torch.cat([a, b]) for a, b in zip(opsA, opsB)]
    perm = lexsort2(cols[0], cols[1])
    return tuple(c[perm] for c in cols)


def merge_sorted_streams(opsA, opsB):
    """One ascending stream from two (see the module docstring)."""
    _check_cols(opsA, opsB)
    if opsA[0].device.type == "cpu":
        return merge_plain(opsA, opsB)
    E1, E2 = opsA[0].shape[0], opsB[0].shape[0]
    dev = opsA[0].device
    for i, (a, b) in enumerate(zip(opsA, opsB)):
        check(a, torch.int64, (E1,), f"merge_sorted_streams A column {i}")
        check(b, torch.int64, (E2,), f"merge_sorted_streams B column {i}")
    M = E1 + E2
    out = torch.empty((len(opsA), M), dtype=torch.int64, device=dev)
    if M == 0:
        return tuple(out)
    nsplits = -(-M // MERGE_TILE) + 1
    splits = torch.empty(nsplits, dtype=torch.int64, device=dev)
    ap, _k1 = ptr_array(opsA)
    bp, _k2 = ptr_array(opsB)
    op, _k3 = ptr_array(list(out))
    lib = build_kernels()["merge_path"]
    rc = lib.merge_path_launch(ap, bp, op, len(opsA), E1, E2, ptr(splits),
                               nsplits, stream())
    raise_on(rc, "merge_path")
    LAUNCHES["merge_path"] += 1
    return tuple(out)

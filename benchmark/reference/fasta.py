"""A plain FASTA reader: names and base codes (A C G T -> 0 1 2 3, case
ignored), one array a record."""

from __future__ import annotations

import numpy as np

_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c | 0x20] = _i


def read_fasta(path: str, lower: bool = False):
    """(names, codes) of every record; with ``lower`` also, per record, a
    boolean array of its lower-case (soft-masked) bases."""
    with open(path, "rb") as f:
        data = f.read()
    names, seqs, lows = [], [], []
    for rec in data.split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        raw = np.frombuffer(body.replace(b"\n", b""), np.uint8)
        codes = _CODE[raw]
        if (codes == 255).any():
            raise ValueError(f"{path}: a base other than ACGT in "
                             f"{head.decode()}")
        names.append(head.split()[0].decode() if head.split() else "")
        seqs.append(codes)
        if lower:
            lows.append((raw & 0x20) != 0)
    return (names, seqs, lows) if lower else (names, seqs)


def revcomp(s: np.ndarray) -> np.ndarray:
    return (3 - s)[::-1].copy()

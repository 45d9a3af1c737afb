"""The record every output form is read into."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Record:
    """One alignment: A contig ``a`` [ab, ae) against B contig ``b``;
    with ``comp`` the B coordinates are on B's reverse complement (as in a
    .1aln file).  ``trace``: per A panel (diffs, B advance), or None where
    the form carries none (PAF)."""
    a: int
    b: int
    comp: bool
    ab: int
    ae: int
    bb: int
    be: int
    diffs: int
    trace: Optional[List[tuple]] = field(default=None)

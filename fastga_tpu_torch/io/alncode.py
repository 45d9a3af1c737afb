# Copied from fastga_tpu/io/alncode.py; imports point at fastga_tpu_torch.
""".1aln Overlap records (the reference's align.h Overlap).  The .1aln
readers and writers come with the CLI slice."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class Overlap:
    """One local alignment (align.h Overlap/Path semantics).

    ``bcomp``: b coordinates are in B-complement space (the `R` line).
    ``trace``: list of (diffs, b-advance) per trace interval.
    """
    aread: int
    bread: int
    abpos: int
    aepos: int
    bbpos: int
    bepos: int
    diffs: int
    bcomp: bool
    trace: List[Tuple[int, int]] = field(default_factory=list)



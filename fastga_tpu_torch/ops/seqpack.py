# Copied from fastga_tpu/ops/seqpack.py; imports point at fastga_tpu_torch.
"""2-bit packed sequence pool for device kernels.

All contigs (A forward, A reverse-complement, B forward) are packed 16
bases/int32 word (base i in bits [2*(i%16), 2*(i%16)+2) — little-endian in
word so that "first mismatch" = count-trailing-zeros) into one device-resident
pool.  Kernels address sequences by (word offset, length) pairs; a fetch of
16 bases starting at arbitrary base offset is two word gathers + a funnel
shift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

BASES_PER_WORD = 16


def pack_u32(codes: np.ndarray) -> np.ndarray:
    """Numeric bases -> int32 words, base i at bits 2*(i%16).. (LE)."""
    n = len(codes)
    pad = (-n) % BASES_PER_WORD
    c = np.concatenate([codes.astype(np.uint64),
                        np.zeros(pad, dtype=np.uint64)])
    c = c.reshape(-1, BASES_PER_WORD)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint64))[None, :]
    return (c << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)


@dataclass
class SeqPool:
    """Concatenated packed sequences + per-sequence (word offset, length)."""
    words: np.ndarray                  # uint32[total_words]
    offs: Dict[Tuple[int, int], Tuple[int, int]]  # (contig_key) -> (woff, len)

    @staticmethod
    def build(seqs: Dict, target_words: int = 0) -> "SeqPool":
        """seqs: key -> numeric uint8 array.

        The pool is padded to a power-of-two word count (at least
        ``target_words``): device kernels are compiled per pool shape, so
        bucketing keeps one compile per size class instead of one per
        genome."""
        # 5 guard words before the first sequence and after every sequence
        # so 5-word (64-base + spill) fetches never cross sequences and
        # negative word indices never clamp onto real data
        chunks: List[np.ndarray] = [np.zeros(5, dtype=np.uint32)]
        offs = {}
        woff = 5
        for k, s in seqs.items():
            w = pack_u32(np.asarray(s, dtype=np.uint8))
            chunks.append(w)
            chunks.append(np.zeros(5, dtype=np.uint32))
            offs[k] = (woff, len(s))
            woff += len(w) + 5
        words = np.concatenate(chunks)
        # pow2 bucket (>= 1024: the pallas wave kernel builds overlapping
        # 1024-word pages at 512 stride and needs a whole page)
        target = max(1024, int(target_words))
        target = 1 << (max(len(words), target) - 1).bit_length()
        if len(words) < target:
            words = np.concatenate(
                [words, np.zeros(target - len(words), dtype=np.uint32)])
        return SeqPool(words, offs)

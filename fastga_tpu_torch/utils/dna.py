# Copied from fastga_tpu/utils/dna.py; imports point at fastga_tpu_torch.
"""DNA codecs: 2-bit packing, complement, numeric<->ASCII conversion.

Semantics follow the reference's gene_core.c (Compress_Read/Uncompress_Read,
gene_core.c:349-398): a ``.bps`` byte packs base i of a 4-base group at bit
position 2*(i mod 4) ("little-endian within byte").  K-mer bytes used by the
GIX index pack the *opposite* way (big-endian base order, GIXmake.c:922-926);
see ops.syncmer for those.

Bases are numbered a=0, c=1, g=2, t=3; 4 is the out-of-sequence sentinel
(gene_core.h:158-170).  All functions here are host-side numpy (bulk IO).
"""

from __future__ import annotations

import numpy as np

# Base numbering (matches reference order 'acgt').
BASE_ORDER = b"acgt"
SENTINEL = 4

# ASCII -> numeric code; non-acgt (incl. N) maps to 255 so callers can detect.
_ASCII_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"acgt"):
    _ASCII_TO_CODE[_c] = _i
    _ASCII_TO_CODE[_c - 32] = _i  # upper case
ASCII_TO_CODE = _ASCII_TO_CODE

# numeric -> lower/upper ASCII
CODE_TO_LOWER = np.frombuffer(b"acgt", dtype=np.uint8).copy()
CODE_TO_UPPER = np.frombuffer(b"ACGT", dtype=np.uint8).copy()

# Case detection: True for 'a','c','g','t' lower-case ASCII
_IS_LOWER = np.zeros(256, dtype=bool)
for _c in b"acgt":
    _IS_LOWER[_c] = True
_IS_ACGT = np.zeros(256, dtype=bool)
for _c in b"acgtACGT":
    _IS_ACGT[_c] = True
_IS_UPPER = _IS_ACGT & ~_IS_LOWER
IS_LOWER = _IS_LOWER
IS_ACGT = _IS_ACGT


def compress(codes: np.ndarray) -> np.ndarray:
    """Pack numeric bases (uint8 in [0,3]) into 2-bit bytes, base i at bit 2*(i%4).

    Mirrors Compress_Read (gene_core.c:349-368): output has ceil(len/4) bytes,
    trailing slots of the last byte are zero.
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    q = codes.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)).astype(np.uint8)


def uncompress(packed: np.ndarray, length: int, beg: int = 0) -> np.ndarray:
    """Unpack 2-bit bytes into numeric bases; returns ``length`` bases starting
    at in-byte offset ``beg`` (0..3) of the first byte (cf. Uncompress_Read)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty((len(packed), 4), dtype=np.uint8)
    out[:, 0] = packed & 0x3
    out[:, 1] = (packed >> 2) & 0x3
    out[:, 2] = (packed >> 4) & 0x3
    out[:, 3] = (packed >> 6) & 0x3
    flat = out.reshape(-1)
    return flat[beg : beg + length]


def complement(codes: np.ndarray) -> np.ndarray:
    """Complement numeric bases (0<->3, 1<->2); sentinel 4 maps to 4."""
    codes = np.asarray(codes)
    return np.where(codes < 4, 3 - codes, codes).astype(codes.dtype)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a numeric base vector."""
    return complement(codes[::-1])


def to_ascii(codes: np.ndarray, upper: bool = False) -> bytes:
    """Numeric bases -> ASCII bytes ('acgt' or 'ACGT')."""
    table = CODE_TO_UPPER if upper else CODE_TO_LOWER
    return table[np.asarray(codes, dtype=np.uint8)].tobytes()


def from_ascii(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII -> numeric codes; non-acgt become 255 (callers decide N handling)."""
    if isinstance(seq, (bytes, bytearray, memoryview)):
        seq = np.frombuffer(seq, dtype=np.uint8)
    return ASCII_TO_CODE[seq]


def base_frequencies(codes: np.ndarray) -> np.ndarray:
    """Frequency of a,c,g,t among the coded (non-255) bases; float64[4]."""
    valid = codes[codes < 4]
    if len(valid) == 0:
        return np.full(4, 0.25)
    return np.bincount(valid, minlength=4)[:4] / len(valid)

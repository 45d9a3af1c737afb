# Copied from fastga_tpu/utils/fmt.py; imports point at fastga_tpu_torch.
"""Number formatting helpers (gene_core.c Print_Number/Number_Digits)."""

from __future__ import annotations


def number_digits(num: int) -> int:
    num = abs(int(num))
    n = 1
    while num >= 10:
        num //= 10
        n += 1
    return n


def comma_number(num: int, width: int = 0) -> str:
    """Right-aligned comma-separated number; width covers the leading group
    only when the tail groups already occupy >= width chars (Print_Number
    gene_core.c semantics: the %*d pad applies to the first group)."""
    num = int(num)
    if num < 1000:
        return f"{num:>{width}d}" if width else str(num)
    groups = []
    n = num
    while n >= 1000:
        groups.append(f"{n % 1000:03d}")
        n //= 1000
    groups.reverse()
    tail = "," + ",".join(groups)
    lead_width = width - 4 * len(groups)
    head = f"{n:>{lead_width}d}" if width and lead_width > 0 else str(n)
    return head + tail

"""Peaks of the card and the least time of the kernels the rooflines read.

Frozen copy of ``chip_smoke.py``'s yardstick as of commit 1ef7a55:
``HBM_BYTES_PER_S``, ``OPS_PER_S`` and ``OPS_CHUNK_SLOT``, ``bound``,
``_pool_span_bytes``, ``slot_waves`` and ``chunk_bound`` (here
on the card's own tensors, summed without a read back), and ``check_scan``'s
byte count of a fused_scan call.  Peaks: one NVIDIA H100 SXM (NVIDIA's data
sheet): 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores,
against which 32-bit integer work is counted (a lower time bound either
way).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_CHUNK_SLOT = 40     # integer operations per in-band slot of a live wave


def bound_s(nbytes, nops):
    """The larger of the two floors, seconds (tensors or numbers)."""
    tb = nbytes / HBM_BYTES_PER_S
    to = nops / OPS_PER_S
    try:
        import torch
        if isinstance(tb, torch.Tensor) or isinstance(to, torch.Tensor):
            return torch.maximum(torch.as_tensor(tb), torch.as_tensor(to))
    except ImportError:
        pass
    return max(tb, to)


def wave_chunk_bound_s(st0, st_k, ch_k):
    """Least seconds of one wave_chunk launch: bytes (state in and out, a
    log row and kbase word per live wave, the pool words the live lanes
    span, the tube columns) against operations (per in-band slot of a
    live wave), as a 0-d tensor on the launch's device."""
    import torch
    n, W = st0[0].shape
    live = (st_k[17].long() - st0[17].long()).clamp(min=0)
    a0 = st0[7].double()
    a1 = st_k[7].double()
    bases = (a1 - a0).abs() / 2 + 64 + 16
    span = 2 * torch.ceil(bases / 16).sum() * 4
    nbytes = (2 * (n * W * 16 + n * 16 * 4) + live.sum().double() * (W + 4)
              + span + 6 * n * 4)
    G = ch_k.shape[0]
    rows = (torch.arange(G, device=ch_k.device)[:, None] < live[None, :])
    slots = ((ch_k != 3).sum(2) * rows).sum().double()
    return bound_s(nbytes, slots * OPS_CHUNK_SLOT)


def fused_scan_bound_s(values, flags, wide):
    """Least seconds of one fused_scan call: 4 bytes a row for each flag,
    each channel's value read once and written once."""
    M = values[0].shape[0]
    esize = 8 if wide else 4
    return bound_s(M * (4 * len(flags) + 2 * esize * len(values)), 0)

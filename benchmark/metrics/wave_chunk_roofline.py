"""wave_chunk's share of its roofline, percent: the least time of its
launches (bytes over HBM rate or integer operations over the float32
peak, the larger, per launch; ``core/roofline.py``) over its device time
in the profiler."""

from core import roofline

KERNEL = r"wave_chunk_kernel"
WRAPS = [("fastga_tpu_torch.ops.wave_kernels", "wave_chunk")]


def least_s(call, out):
    return roofline.wave_chunk_bound_s(call["st"], out[0], out[1])


def read(ctx):
    return ctx.roofline("wave_chunk_roofline")

"""fused_scan's share of its roofline, percent: the least time of its
calls (bytes over HBM rate; ``core/roofline.py``) over its device time in
the profiler."""

from core import roofline

KERNEL = r"(^|[^A-Za-z0-9_])scan_kernel[<(]"
WRAPS = [("fastga_tpu_torch.ops.device_pipeline", "fused_scan")]


def least_s(call, out):
    wide = tuple(call["spec"])[0][0] == "sum64"
    return roofline.fused_scan_bound_s(call["values"], call["flags"], wide)


def read(ctx):
    return ctx.roofline("fused_scan_roofline")

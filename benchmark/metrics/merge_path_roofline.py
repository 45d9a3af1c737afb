"""merge_path's share of its roofline, percent: the least time of its
calls (``merge_splits`` and ``merge_tiles``, ``csrc/merge_path.cu``; 16
bytes a row and column, each input word read once and each output word
written once, over HBM rate, as ``chip_smoke.check_merge`` bounds it)
over their device time in the profiler."""

from core import roofline

KERNEL = r"(^|[^A-Za-z0-9_])merge_(splits|tiles)[<(]"
WRAPS = [("fastga_tpu_torch.ops.device_pipeline", "merge_sorted_streams")]


def least_s(call, out):
    cols = len(call["opsA"])
    rows = call["opsA"][0].shape[0] + call["opsB"][0].shape[0]
    return roofline.bound_s(16 * rows * cols, 0)


def read(ctx):
    return ctx.roofline("merge_path_roofline")

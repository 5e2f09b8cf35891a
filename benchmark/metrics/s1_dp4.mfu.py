"""Rank 0's profiled steps' counted dense operations (three times the forward
of benchmark/roofline/counts.py stage1_forward_flops, the segments standing
in for the clusters) over the profiled window, as a percentage of the H100's
989 TFLOP/s."""

from benchmark.roofline.peaks import BF16_FLOPS


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("flops") or tr["window_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / tr["window_s"] / BF16_FLOPS

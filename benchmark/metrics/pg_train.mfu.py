"""The profiled steps' counted operations of the U-Net and the heads
(benchmark/roofline/pointgroup.py, from their batches' voxel coordinates;
the ScoreNet left out) over the profiled window, as a percentage of the
H100's 989 TFLOP/s."""

from benchmark.roofline.peaks import BF16_FLOPS


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("flops") or tr["window_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / tr["window_s"] / BF16_FLOPS

"""K2 (csrc/subm_conv.cu, the submanifold conv's forward and data gradient)'s
share of its roofline, in percent: the least seconds its calls in the
profiled steps could take (benchmark/roofline/counts.py, from the batches'
coordinates) over the device seconds of its kernels by name."""


def read(ctx: dict):
    if not ctx.get("k2_s") or ctx.get("k2_bound_s") is None:
        return None
    return 100.0 * ctx["k2_bound_s"] / ctx["k2_s"]

"""K3 (csrc/subm_dw.cu, the submanifold conv's weight gradient)'s share of its
roofline, in percent: the least seconds its calls in the profiled steps
could take (benchmark/roofline/counts.py, from the batches' coordinates)
over the device seconds of its kernels by name."""


def read(ctx: dict):
    if not ctx.get("k3_s") or ctx.get("k3_bound_s") is None:
        return None
    return 100.0 * ctx["k3_bound_s"] / ctx["k3_s"]

"""K4 (csrc/cc_sweep.cu, the clustering's label-min sweep)'s share of its
roofline, in percent: the sweeps of the profiled steps (its kernel's
launches in the trace) times the least seconds of one sweep over the
batch's doubled valid points (benchmark/roofline/pointgroup.py), over the
device seconds of its kernel by name."""


def read(ctx: dict):
    if not ctx.get("k4_s") or ctx.get("k4_bound_s") is None:
        return None
    return 100.0 * ctx["k4_bound_s"] / ctx["k4_s"]

"""Share of the profiled window in which no kernel ran on the device, in
percent: 1 - (union of kernel intervals) / window."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or tr["window_s"] <= 0 or tr["launches"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

"""Sweeps of the clustering's connected components a step (K4 launches,
the recorder's counter "cc.sweeps"), over the clocked steps that clustered."""


def read(ctx: dict):
    phases = ctx.get("phases", {})
    if not phases.get("count.clustering"):
        return None
    return phases.get("count.cc.sweeps", 0) / phases["count.clustering"]

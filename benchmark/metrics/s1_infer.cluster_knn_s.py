"""Seconds a scene in the per-cluster kNN (the port's PhaseClock "cluster_knn",
ops/knn.py), over the traced window's clocked scenes."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "cluster_knn" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["cluster_knn"] / units

"""Seconds a scene in the grouping loops (the port's PhaseClock "grouping",
ops/grouping.py), over the traced window's clocked scenes."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "grouping" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["grouping"] / units

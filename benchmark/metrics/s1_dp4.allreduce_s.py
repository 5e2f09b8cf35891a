"""Seconds a step in rank 0's "all-reduce" phase (the stage-1 trainer's
PhaseClock), over the traced window's clocked steps."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "all-reduce" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["all-reduce"] / units

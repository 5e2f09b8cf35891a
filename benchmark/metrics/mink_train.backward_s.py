"""Seconds a step in the backward (the trainer's PhaseClock "backward"), over
the traced window's clocked steps."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "backward" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["backward"] / units

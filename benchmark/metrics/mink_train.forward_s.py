"""Seconds a step in the forward and loss (the trainer's PhaseClock "forward"),
over the traced window's clocked steps."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "forward" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["forward"] / units

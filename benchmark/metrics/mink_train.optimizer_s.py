"""Seconds a step in SGD and the PolyLR schedule (the trainer's fenced phase
"optimizer"), over the traced window's clocked steps."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "optimizer" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["optimizer"] / units

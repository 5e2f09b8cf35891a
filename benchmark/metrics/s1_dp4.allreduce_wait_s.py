"""Seconds a step rank 0 waited at Mesh.sync's barrier for the slowest rank
(the recorder's span "all-reduce.wait", inside the "all-reduce" phase), over
the traced window's clocked steps."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "all-reduce.wait" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["all-reduce.wait"] / units

"""Union steps a scene that the grouping launches (the recorder's
"count.unions" in ops/grouping.py, counted from the lengths the host holds
before each pass), over the traced window's clocked scenes."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "count.unions" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["count.unions"] / units

"""Seconds a scene in the label export (the port's PhaseClock "export" around
infer.export_scene), over the traced window's clocked scenes."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "export" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["export"] / units

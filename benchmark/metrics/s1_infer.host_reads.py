"""Reads of the card a scene in the forward and the export (the recorder's
"count.host.read": the timed reads and the union loops' implicit ones), over
the traced window's clocked scenes."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "count.host.read" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["count.host.read"] / units

"""Seconds a scene the host blocked on the card in the reads it makes through
the recorder (the span "host.read": profiling.to_host and profiling.nonzero
in the forward and the export, unfenced), over the traced window's clocked
scenes. The union loops' implicit reads are counted, not timed."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "host.read" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["host.read"] / units

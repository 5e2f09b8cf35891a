"""Seconds a step the train loop waited for the prefetcher's next batch (the
benchmark's clock around taking it), over the traced window's clocked steps."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "batch_wait_s" not in ctx:
        return None
    return ctx["batch_wait_s"] / units

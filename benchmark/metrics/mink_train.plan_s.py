"""Seconds a step in batch_on_device: the wire's unpack and the device plan
(the recorder's fenced phase "plan"), over the steps it timed (the binding
starts after the first clocked step's plan)."""


def read(ctx: dict):
    phases = ctx.get("phases", {})
    if not phases.get("count.plan"):
        return None
    return phases["plan"] / phases["count.plan"]

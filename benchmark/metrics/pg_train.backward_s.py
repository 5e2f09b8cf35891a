"""Seconds a step in the backward of the loss (train_step's fenced phase
"backward"), over the steps it timed."""


def read(ctx: dict):
    phases = ctx.get("phases", {})
    if not phases.get("count.backward"):
        return None
    return phases["backward"] / phases["count.backward"]

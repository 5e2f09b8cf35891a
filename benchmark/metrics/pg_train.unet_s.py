"""Seconds a step in the 7-level U-Net and the heads (the trainer's fenced
phase "unet"), over the steps it timed."""


def read(ctx: dict):
    phases = ctx.get("phases", {})
    if not phases.get("count.unet"):
        return None
    return phases["unet"] / phases["count.unet"]

"""Proposals a step that reach the ScoreNet (the recorder's counter
"clustering.proposals"), over the clocked steps that clustered."""


def read(ctx: dict):
    phases = ctx.get("phases", {})
    if not phases.get("count.clustering") or "count.clustering.proposals" not in phases:
        return None
    return phases["count.clustering.proposals"] / phases["count.clustering"]

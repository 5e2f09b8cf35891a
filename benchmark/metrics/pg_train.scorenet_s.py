"""Seconds a step in the ScoreNet over the proposals' voxels (the fenced phase
"scorenet"), over the steps it timed."""


def read(ctx: dict):
    phases = ctx.get("phases", {})
    if not phases.get("count.scorenet"):
        return None
    return phases["scorenet"] / phases["count.scorenet"]

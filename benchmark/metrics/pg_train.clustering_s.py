"""Seconds a step in the dual clustering and the proposals' re-voxelisation
(the fenced phase "clustering"), over the steps it timed."""


def read(ctx: dict):
    phases = ctx.get("phases", {})
    if not phases.get("count.clustering"):
        return None
    return phases["clustering"] / phases["count.clustering"]

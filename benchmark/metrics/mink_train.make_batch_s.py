"""Seconds a prefetch thread takes to make one batch (make_batch: the
augmentation, the voxelisation and the wire; the recorder's span
"prefetch.make" on the HostPrefetcher's threads), over the batches it timed."""


def read(ctx: dict):
    phases = ctx.get("phases", {})
    if not phases.get("count.prefetch.make"):
        return None
    return phases["prefetch.make"] / phases["count.prefetch.make"]

"""Seconds a step the train loop waited for its next batch, by the program's
own clock (the recorder's span "prefetch_wait" in HostPrefetcher.__next__),
over the waits it timed."""


def read(ctx: dict):
    phases = ctx.get("phases", {})
    if not phases.get("count.prefetch_wait"):
        return None
    return phases["prefetch_wait"] / phases["count.prefetch_wait"]

"""Label files a scene that the port's native library formatted (the
recorder's "count.export.native" in infer.export_labels_txt: 15 a scene
when it ran, none where the numpy fallback did), over the traced window's
clocked scenes."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "count.export.native" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["count.export.native"] / units

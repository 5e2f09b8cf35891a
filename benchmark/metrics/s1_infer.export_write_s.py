"""Seconds a scene opening and writing the label files (the recorder's span
"export.write" in infer.export_labels_txt, 15 a scene), over the traced
window's clocked scenes."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "export.write" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["export.write"] / units

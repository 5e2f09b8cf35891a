"""Seconds a scene turning the exported labels into text (the recorder's span
"export.format" in infer.export_labels_txt, 15 a scene), over the traced
window's clocked scenes."""


def read(ctx: dict):
    units = ctx.get("phase_units")
    if not units or "export.format" not in ctx.get("phases", {}):
        return None
    return ctx["phases"]["export.format"] / units

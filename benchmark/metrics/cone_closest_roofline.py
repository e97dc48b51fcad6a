"""K7 (the cone closest hit): the f32 operations of the cone tests its rays need at
the card's f32 rate (bounds.py), over K7's device time a replayed frame (the
profile), in %. `cone_closest_roofline.viewport` reads it
in the viewport cells."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace.get("k7_bound_s"):
        return None
    k7_ms = trace["replayed"]["family_ms_per_launch"].get("cone_closest")
    return trace["k7_bound_s"] * 1e3 / k7_ms * 100.0 if k7_ms else None

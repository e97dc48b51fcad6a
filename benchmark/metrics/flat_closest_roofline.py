"""K2 (the closest hit over a flat triangle list): the f32 operations of the
group boxes and triangles its rays need at the card's f32 rate, or their
bytes where more (bounds.py), over K2's device time a replayed frame (the
profile), in %. The hair cells call K2 on their ground quad too, and do
not report this metric."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace.get("k2_bound_s"):
        return None
    k2_ms = trace["replayed"]["family_ms_per_launch"].get("intersect_closest")
    return trace["k2_bound_s"] * 1e3 / k2_ms * 100.0 if k2_ms else None

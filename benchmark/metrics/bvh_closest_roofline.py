"""K5 (the BVH closest hit): the bytes its rays and the triangles they need take at
the card's bandwidth (bounds.py), over K5's device time a replayed frame (the
profile), in %. `bvh_closest_roofline.viewport` reads it in
the viewport cells."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace.get("k5_bound_s"):
        return None
    k5_ms = trace["replayed"]["family_ms_per_launch"].get("bvh_closest")
    return trace["k5_bound_s"] * 1e3 / k5_ms * 100.0 if k5_ms else None

"""Scene tables, BVH, cones and the eager first launch: the first render() to a synchronize."""


def read(run):
    return run["spans"].get("first_launch_s")

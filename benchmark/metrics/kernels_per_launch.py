"""The launch's graph length: CUDA kernels a replayed frame, from the profile. `kernels_per_launch.viewport` reads it in the viewport cells."""


def read(run):
    trace = run.get("trace")
    return trace["replayed"]["kernels_per_launch"] if trace else None

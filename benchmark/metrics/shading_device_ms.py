"""The plain PyTorch shading, textures included: a replayed frame's device ms
(CUDA events) less the hand-written kernels' (by name, from the profile of
the same kind of replayed frames).
`shading_device_ms.viewport` reads it in the viewport cells."""


def read(run):
    trace = run.get("trace")
    if not trace or trace["frame_device_ms"] is None:
        return None
    value = trace["frame_device_ms"] - sum(trace["replayed"]["family_ms_per_launch"].values())
    return value if value > 0 else None

"""Textures: device time of the kernels launched under the texture range, on the
eager launch of the frame's config key (a replay carries no host range); a
part of the shading's time. `texture_device_ms.viewport` reads it in the
viewport cells."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace["has_textures"]:
        return None
    value = trace["eager"]["range_ms_per_launch"].get("texture_path")
    return value if value else None

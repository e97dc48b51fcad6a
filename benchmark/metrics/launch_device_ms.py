"""The launch: device ms of a replayed frame (its graph replay and the frame's
own copies, tonemap and resize), by CUDA events from the mark before the
replay is enqueued to the event behind the frame's work, over the traced
frames. `launch_device_ms.viewport` reads it in the viewport cells."""


def read(run):
    trace = run.get("trace")
    return trace["frame_device_ms"] if trace else None

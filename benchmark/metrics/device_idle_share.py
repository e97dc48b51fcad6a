"""The device: the share of the traced frames' wall time in which the card
did no work, in %: one less the frames' device seconds by CUDA events (each
replayed frame's work and, in the viewport, its display copy) over their
wall seconds. (A profile cannot give it: the profiler stretches a graph's
replay and the host's calls between replays.) `device_idle_share.converge`
and `.viewport` read it in their cells."""


def read(run):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0

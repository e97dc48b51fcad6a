"""Scene tables, BVH and cones: seconds of the program's own set-up span
`device_scene.build` (strelka_tpu_torch/utils/profiling.py: the tables, the
BVH or the cones built and copied to the card, inside the first render()),
the newest one recorded in this process. The recorder keeps its set-up spans
whatever its state, and the run's record does not carry them, so the reader
asks the program's recorder in the process that ran the cell; a program
without the recorder gives nothing."""

import sys

PROFILING = "strelka_tpu_torch.utils.profiling"


def read(run):
    spans = getattr(sys.modules.get(PROFILING), "setup_spans", None)
    if spans is None:
        return None
    found = [s for s in spans() if s["name"] == "device_scene.build"]
    return (found[-1]["end_ns"] - found[-1]["start_ns"]) / 1e9 if found else None

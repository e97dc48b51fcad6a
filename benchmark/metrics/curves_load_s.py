"""Scene ingestion: seconds of the program's BasisCurves bakes, the sum of its
set-up spans `usd.curves` (strelka_tpu_torch/loaders/usd.py: each prim's
points and widths converted, inside `scene.load`) recorded in this process.
The recorder keeps its set-up spans whatever its state, and the run's record
does not carry them, so the reader asks the program's recorder in the
process that ran the cell; a program without the span gives nothing."""

import sys

PROFILING = "strelka_tpu_torch.utils.profiling"


def read(run):
    spans = getattr(sys.modules.get(PROFILING), "setup_spans", None)
    if spans is None:
        return None
    found = [s for s in spans() if s["name"] == "usd.curves"]
    return sum(s["end_ns"] - s["start_ns"] for s in found) / 1e9 if found else None

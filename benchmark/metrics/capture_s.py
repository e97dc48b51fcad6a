"""The launch cache: the second render(), which captures the launch's CUDA graph, to a synchronize."""


def read(run):
    return run["spans"].get("capture_s")

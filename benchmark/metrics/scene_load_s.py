"""Scene ingestion: seconds of the program's stage load or scene build (the benchmark's span)."""


def read(run):
    return run["spans"].get("scene_load_s")

"""The display copy: mean ms of Buffer.map() over the window's frames, each after the
frame's work has completed on the card."""


def read(run):
    return run["window"].get("display_ms")

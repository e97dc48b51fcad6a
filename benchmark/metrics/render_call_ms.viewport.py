"""The library API's host side: mean ms of render() over the window's frames (no synchronize inside)."""


def read(run):
    return run["window"].get("render_call_ms")

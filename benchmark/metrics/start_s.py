"""Process and renderer start: the process's start to the harness's first step
(the interpreter, torch, the program's import, the card's context)."""


def read(run):
    return run["spans"].get("start_s")

"""Seconds from the process's start to the window's opening: imports, the
weights drawn, the engine built and warmed up, the pre-roll."""


def read(run):
    return run.setup_s

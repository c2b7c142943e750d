"""Every token emitted inside the window over the window's seconds."""


def read(run):
    return run.tokens / run.window_s

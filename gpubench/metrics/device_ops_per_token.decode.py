"""Device operations (kernels, copies, fills) in the traced window per
token emitted in it."""


def read(run):
    if run.trace is None or not run.tokens or not run.trace.device_ops:
        return None
    return run.trace.device_ops / run.tokens

"""Share of the traced window in which no device operation ran."""
from gpubench.readers import device_idle


def read(run):
    return device_idle(run)

"""90th percentile of the time to first token, from when each counted
request was due; a failed or unfinished request misses every limit."""
from gpubench.readers import ttft_ms


def read(run):
    return ttft_ms(run, 0.9)

"""90th percentile over the counted requests of (last token − first token)
/ (tokens − 1), each followed to its end."""
from gpubench.readers import tpot_ms


def read(run):
    return tpot_ms(run, 0.9)

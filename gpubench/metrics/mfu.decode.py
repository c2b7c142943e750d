"""The whole step's share of the card's peak in the batch-decode cells
(``readers.mfu``)."""
from gpubench.readers import mfu


def read(run):
    return mfu(run)

"""The whole step's share of the card's peak in the long-prompt online cell
(``readers.mfu``)."""
from gpubench.readers import mfu


def read(run):
    return mfu(run)

"""`steps_per_s` in the cells whose step the host paces: the device idles
between launches, so the rate follows the host's speed, which the card's
machine shares with others (the wider bound)."""
from portbench.spec import reader


def read(run):
    return reader("steps_per_s")(run)

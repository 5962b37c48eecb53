"""The planned gathers (K2, and K5 where the chain permute streams)
against their byte bound over the traced chunk, in %: each launch reads
its ids and at most as many table entries, and writes its outputs, once."""
from portbench.trace import roofline


def read(run):
    return roofline(run.trace, ("gather", "gather_stream"), "gather")

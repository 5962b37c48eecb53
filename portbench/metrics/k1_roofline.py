"""The scaler MLP's kernels (K1 forward and backward) against their
roofline over the traced chunk, in %: the sum of each launch's bound (the
larger of its operations over the card's f32 peak and its bytes over its
bandwidth, counted from its shapes) over the kernels' device time."""
from portbench.trace import roofline

K1 = ("trunk_fwd", "trunk_bwd", "trunk_wide_fwd", "trunk_wide_bwd")


def read(run):
    return roofline(run.trace, K1, "k1")

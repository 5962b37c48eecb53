"""The host's milliseconds a step in the ELBO's forward (the surrogate's
draw, the scaler, the likelihood with its gathers, the prior's KL): the
median careless.elbo span of the program's record over the traced
chunk's steps."""
from portbench.spans import step_ms


def read(run):
    return step_ms(run, "careless.elbo")

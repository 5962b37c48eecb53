"""The host's milliseconds a merge step over the traced chunk: the median
careless.step span of the program's record (the ELBO's enqueue, autograd's
backward, the gradient transform, Adam and the metrics row). Where the card
paces the step (mono-30M) this is the step's wall time: it holds the host's
waits in the step's blocking copies, which last until the card has done the
last step's work."""
from portbench.spans import STEP, step_ms


def read(run):
    return step_ms(run, STEP)

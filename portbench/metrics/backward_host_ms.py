"""The host's milliseconds a step in autograd's backward (Trainer.gradients'
torch.autograd.grad, which enqueues every backward kernel): the median
careless.backward span of the program's record over the traced chunk's
steps."""
from portbench.spans import step_ms


def read(run):
    return step_ms(run, "careless.backward")

"""The host's milliseconds a step from the flat gradients through Adam (the
flatten, norm, non-finite zeroing, clips, split, .grad and opt.step()): the
median over the traced chunk's steps of a step's careless.update ranges
(the transform, then .grad and Adam) in the program's record."""
from portbench.spans import step_ms


def read(run):
    return step_ms(run, "careless.update")

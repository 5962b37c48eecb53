"""Process start to the first step of the window: imports, the kernel
library's build or load, the problem, the model, the layout and plans, and
the warm-up steps (host clock)."""


def read(run):
    return run.setup_s

"""Full-batch merge steps per second: every step of the window over the
window's wall time, to its last chunk's synchronise (host clock)."""


def read(run):
    return run.steps / run.wall

"""`host_ms_per_step` in the cells whose step the host paces, where it moves
`steps_per_s.host_paced`."""
from portbench.spec import reader


def read(run):
    return reader("host_ms_per_step")(run)

"""The whole step's share of the card's f32 peak in %: the scaler MLP's
model FLOPs a step (forward, and twice that backward, no recompute) times
the window's steps over its wall time (host clock), over 67 TFLOP/s (f32
without tensor cores: the configurations are f32)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.model_flops_per_step * run.steps / run.wall \
        / run.peaks[0]

"""Named spans at the training loop's layer boundaries, on exactly while a
torch.profiler session records.

`span(name, args)` is a context manager. While a profiler records (the
benchmark's traced chunk, the CLI's --profile-dir), it enters
torch.profiler.record_function(name, args), so the range lands in the
session's trace beside the operations it enqueues, on the clock of the
device's records (Perfetto shows the Chrome trace's ranges on the host
thread's track). Otherwise it returns one shared nullcontext, whose cost
is a flag read and a call.

While on, each span also notes (name, start, end) on the host's monotonic
clock (time.perf_counter_ns) in RECORDED. That record is a stopgap for the
benchmark's readers, which cannot yet be handed the profiler's own ranges;
once they are, RECORDED and _recorded go, and `span` is record_function
or the nullcontext alone.

Every name starts with "careless.". The spans of Trainer.train, nested on
the thread that calls it: careless.chunk (args: its first step) holds
careless.validation, the chunk's careless.step spans (args: the step), its
careless.sync and careless.checkpoint; a step holds careless.elbo
(careless.surrogate, careless.scaler, careless.likelihood, careless.kl),
careless.backward and two careless.update ranges: the gradient transform
(careless.all_reduce in a sharded run) in Trainer.step_gradients, then the
.grad assignment and careless.adam.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple, Optional, Union

import torch.autograd.profiler as _profiler
from torch.profiler import record_function


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


# the spans of the profiler sessions so far, each appended as it ends
# (children before their parents); the oldest go past this many
RECORDED: collections.deque = collections.deque(maxlen=1 << 16)

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _recorded(name: str, args):
    with record_function(name, None if args is None else str(args)):
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            RECORDED.append(Span(name, start, time.perf_counter_ns()))


def span(name: str, args: Optional[Union[int, str]] = None):
    """record_function(name, args) and a RECORDED entry while a profiler
    records; else the shared nullcontext."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name, args)

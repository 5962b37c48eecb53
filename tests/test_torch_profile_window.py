"""chip_smoke.window_device_times: the device time per step of a profiled
window, when the profiler kept fewer kernel records than the window
launched. A port kernel's records stand for its launches in
kernels.LAUNCHES; another kernel's for its records rounded to a whole
number per step, never fewer than it left; a window without a record of
a port kernel that launched is incomplete. Events are stand-ins for
torch.profiler's key_averages() entries (times in microseconds). The map
of kernel names to LAUNCHES names covers every kernel of csrc/."""
import re
import types
from pathlib import Path

import pytest

import chip_smoke
from careless_tpu_torch import kernels

STEPS = 20
NARROW_BWD = "void (anonymous namespace)::trunk_bwd_f32_kernel<10>(float const*"
NARROW_FWD = "void (anonymous namespace)::trunk_fwd_kernel<10>(float const*"
GATHER = "(anonymous namespace)::gather_kernel(float const*, int const*"
TORCH_GATHER = "void at::native::vectorized_gather_kernel<16, long>(char*"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>"
# a kernel's definition in csrc/: its name after __global__ void and any
# __launch_bounds__(...)
GLOBAL = re.compile(r"__global__\s+void\s+"
                    r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def event(key, count, us_each):
    return types.SimpleNamespace(key=key, count=count,
                                 self_device_time_total=count * us_each)


def launched(**counts):
    return {**{k: 0 for k in kernels.LAUNCHES}, **counts}


def test_dropped_records_of_a_port_kernel_stand_for_its_launches():
    """120 of K2's 140 launches recorded: its time is 140 launches'."""
    rows, stands_for, complete = chip_smoke.window_device_times(
        [event(GATHER, 120, 3.0), event(NARROW_FWD, 20, 50.0),
         event(NARROW_BWD, 19, 600.0)],
        launched(gather=140, trunk_fwd=20, trunk_bwd=20), STEPS)
    assert complete
    assert stands_for == {GATHER: 140, NARROW_FWD: 20, NARROW_BWD: 20}
    by_name = {k: (ms, per) for ms, per, k in rows}
    assert by_name[GATHER] == pytest.approx((3.0 * 140 / 1e3 / STEPS, 7.0))
    assert by_name[NARROW_BWD] == pytest.approx((0.6, 1.0))
    assert rows[0][2] == NARROW_BWD


def test_other_kernels_round_to_whole_launches_per_step():
    """PyTorch's kernels: 78 records of an add run 4 times a step stand for
    80; one launched once in the window stands for itself; PyTorch's own
    gather is not K2."""
    _, stands_for, complete = chip_smoke.window_device_times(
        [event(ADD, 78, 2.0), event("Memcpy HtoD", 1, 5.0),
         event(TORCH_GATHER, 40, 1.0)], launched(), STEPS)
    assert complete
    assert stands_for == {ADD: 80, "Memcpy HtoD": 1, TORCH_GATHER: 40}


def test_other_kernels_stand_for_no_fewer_launches_than_their_records():
    """21 records of a kernel that rounds to once a step (a record from
    before the window, or a launch more) stand for 21 launches, not 20."""
    rows, stands_for, _ = chip_smoke.window_device_times(
        [event(ADD, 21, 2.0)], launched(), STEPS)
    assert stands_for == {ADD: 21}
    assert rows[0][0] == pytest.approx(21 * 2.0 / 1e3 / STEPS)


@pytest.mark.parametrize("kept", [0, 5])
def test_a_port_kernel_without_a_record_leaves_the_window_incomplete(kept):
    events = [event(NARROW_FWD, 20, 50.0)]
    if kept:
        events.append(event(GATHER, kept, 3.0))
    _, _, complete = chip_smoke.window_device_times(
        events, launched(trunk_fwd=20, gather=140), STEPS)
    assert complete is bool(kept)


def test_every_launch_name_and_csrc_kernel_has_one_profiled_group():
    """kernels.PROFILED_KERNELS: each LAUNCHES name in one group, each
    group's kernels defined __global__ in csrc/, and every __global__
    kernel of csrc/ in one group, so that no kernel of the port falls to
    the rounded count of PyTorch's."""
    names = [n for _, group in kernels.PROFILED_KERNELS for n in group]
    assert sorted(names) == sorted(kernels.LAUNCHES)
    csrc = Path(kernels.__file__).resolve().parents[1] / "csrc"
    defined = set(GLOBAL.findall(" ".join(p.read_text()
                                          for p in csrc.glob("*.cu"))))
    symbols = [s.rsplit("::", 1)[1] for group, _ in kernels.PROFILED_KERNELS
               for s in group]
    assert sorted(symbols) == sorted(defined)

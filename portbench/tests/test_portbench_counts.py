"""The operation and byte counts against hand-worked counts, the bound,
and the trace arithmetic on made-up profiler records."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import counts, system, trace
from portbench.peaks import bound, peaks


def test_k1_forward_at_width_10():
    # a row: 10x10 into the first layer, 19 10x10 layers, the 10x2 head,
    # two operations a multiply-add: 2 (100 + 1900 + 20) = 4040
    assert counts.trunk_fwd_flops_per_row(10, 10, 20) == 4040
    flops, nbytes = counts.trunk_fwd(1000, 10, 10, 20)
    weights = 100 + 19 * 100 + 20 * 10 + 11 * 2
    assert flops == 4_040_000
    assert nbytes == 4 * (1000 * 10 + 1000 * 2 + weights)


def test_k1_backward_at_width_10():
    # recompute 4040, dh without the first layer's dx 4040 - 200, dW 4040
    flops, nbytes = counts.trunk_bwd(1000, 10, 10, 20)
    assert flops == 1000 * (4040 + 3840 + 4040)
    weights = 100 + 19 * 100 + 20 * 10 + 11 * 2
    assert nbytes == 4 * (1000 * 10 + 1000 * 2 + 2 * weights)
    flops_dx, bytes_dx = counts.trunk_bwd(1000, 10, 10, 20, need_dx=True)
    assert flops_dx == flops + 1000 * 200
    assert bytes_dx == nbytes + 4 * 1000 * 10


def test_k1_bounds_match_the_kernel_table():
    # at 1M rows the port's kernel table gives 0.0603 and 0.178 ms
    f, b = peaks("NVIDIA H100 80GB HBM3")
    assert bound(*counts.trunk_fwd(10 ** 6, 10, 10, 20), f, b)[0] \
        == pytest.approx(0.0603e-3, rel=1e-3)
    t, by = bound(*counts.trunk_bwd(10 ** 6, 10, 10, 20), f, b)
    assert t == pytest.approx(0.1779e-3, rel=1e-3) and by == "operations"


def test_k1_bound_from_launch_counts():
    f, b = peaks("NVIDIA H100 80GB HBM3")
    one = (bound(*counts.trunk_fwd(10 ** 6, 10, 10, 20), f, b)[0]
           + bound(*counts.trunk_bwd(10 ** 6, 10, 10, 20), f, b)[0])
    launched = {"trunk_fwd": 100, "trunk_bwd": 100, "gather": 700,
                "trunk_bwd_bf16": 0}
    assert system.k1_bound(launched, 10 ** 6, 10, 10, 20, f, b) \
        == pytest.approx(100 * one)
    # a launch whose shapes the sizes do not give: nothing to read
    launched["trunk_only_bwd"] = 1
    assert system.k1_bound(launched, 10 ** 6, 10, 10, 20, f, b) is None


def test_gathers_recorded_by_parameter_name(monkeypatch):
    from careless_tpu_torch import kernels

    def gather(table, ids):
        return table[ids]

    def gather_stream(source, rows, bases, window, block_rows):
        return source
    monkeypatch.setattr(kernels, "gather", gather)
    monkeypatch.setattr(kernels, "gather_stream", gather_stream)
    table, ids = torch.arange(50.0), torch.zeros(1000, dtype=torch.long)
    with system.recorded_gathers() as sizes:
        kernels.gather(table, ids)
        kernels.gather(ids=ids[:10], table=table)
        kernels.gather_stream(table, ids, None, 1, 1)
    assert sizes == [(1000, 50), (10, 50)]
    assert kernels.gather is gather and kernels.gather_stream is gather_stream


def test_model_flops():
    assert counts.model_flops_per_step(10 ** 7, 10, 10, 20) \
        == 3 * 4040 * 10 ** 7


def test_gather_bytes():
    assert counts.gather(1000, 50) == (0, 4 * (2000 + 50))
    assert counts.gather(50, 1000) == (0, 4 * (100 + 50))
    t, by = bound(*counts.gather(10 ** 7, 500_000), 67e12, 3.35e12)
    assert by == "bytes" and t == pytest.approx(82e6 / 3.35e12)


def test_peaks():
    assert peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    assert peaks("NVIDIA H100 PCIe") == (51e12, 2.0e12)


def ev(key, count, us):
    return SimpleNamespace(key=key, count=count, self_device_time_total=us)


GROUPS = ((("(anonymous namespace)::trunk_fwd_kernel",), ("trunk_fwd",)),
          (("(anonymous namespace)::gather_kernel",), ("gather",)))


def test_window_device_times_scales_dropped_records():
    # 10 steps: K1 launched 10 times, 9 records kept; K2 70, all kept; an
    # elementwise kernel 99 records of 100 launches
    events = [ev("void (anonymous namespace)::trunk_fwd_kernel<10>", 9, 900),
              ev("(anonymous namespace)::gather_kernel(...)", 70, 140),
              ev("elementwise", 99, 99)]
    rows, stands, complete = trace.window_device_times(
        events, {"trunk_fwd": 10, "gather": 70}, 10, GROUPS)
    assert complete
    assert stands == {events[0].key: 10, events[1].key: 70,
                      "elementwise": 100}
    by = {k: ms for ms, _, k in rows}
    assert by[events[0].key] == pytest.approx(0.1)   # 100 us a launch
    assert by["elementwise"] == pytest.approx(0.01)
    traced = dict(rows=rows, steps=10, groups=GROUPS, complete=True,
                  bounds={"k1": 0.5e-3})
    assert trace.group_seconds(traced, ("trunk_fwd",)) == pytest.approx(1e-3)
    assert trace.roofline(traced, ("trunk_fwd",), "k1") == pytest.approx(50)
    assert trace.roofline(traced, ("gather",), "gather") is None


def test_a_port_kernel_without_records_gives_no_time():
    _, _, complete = trace.window_device_times(
        [ev("elementwise", 10, 10)], {"trunk_fwd": 10}, 10, GROUPS)
    assert not complete


def test_idle_gaps_and_their_labels():
    device = [(0, 10), (5, 20), (30, 40), (41, 50)]
    gaps = trace.idle_gaps(device)
    assert gaps.tolist() == [[20.0, 30.0], [40.0, 41.0]]
    host = [(0, 100, "train"), (18, 32, "aten::mul"), (39, 45, "aten::add")]
    assert trace.label_gaps(gaps, host) == [["aten::mul", 1e-5],
                                           ["aten::add", 1e-6]]
    assert trace.label_gaps(np.zeros((0, 2)), host) == []

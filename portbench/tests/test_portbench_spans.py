"""portbench/spans.py and the readers of the program's spans on synthetic
spans and device intervals (microseconds): the medians a step, the idle
gaps put down to the innermost span at their middle and summing to the
gaps' total, a gap between chunks outside any span, and each reader's
None where there is no traced chunk or no step span."""
import types

import pytest

from careless_tpu_torch.utils import spans as program
from portbench import spans, spec, trace

READERS = ("host_ms_per_step", "host_ms_per_step.host_paced",
           "elbo_host_ms", "backward_host_ms", "update_host_ms")


def _chunk(t0, first, steps, step_us=(1000, 1200, 1400)):
    """A chunk of `steps` steps from t0, each elbo 40 %, backward 40 %,
    update 20 % of its step in two ranges (the transform, then .grad and
    adam), then a 100 us sync."""
    out, t = [], t0
    for i in range(steps):
        d = step_us[i % len(step_us)]
        out += [("careless.step", t, t + d),
                ("careless.elbo", t, t + 0.4 * d),
                ("careless.backward", t + 0.4 * d, t + 0.8 * d),
                ("careless.update", t + 0.8 * d, t + 0.86 * d),
                ("careless.update", t + 0.86 * d, t + d),
                ("careless.adam", t + 0.9 * d, t + d)]
        t += d
    out.append(("careless.sync", t, t + 100))
    return [("careless.chunk", t0, t + 100)] + out, t + 100


def _two_chunks():
    a, end = _chunk(0.0, 0, 3)
    b, _ = _chunk(end + 500, 3, 3, step_us=(2000, 2000, 2600))
    return a + b


def test_per_step_medians_of_the_last_chunk():
    got = spans.per_step_ms(spans.last_chunk(_two_chunks()))
    assert got["careless.step"] == pytest.approx(2.0)
    assert got["careless.elbo"] == pytest.approx(0.8)
    assert got["careless.backward"] == pytest.approx(0.8)
    assert got["careless.update"] == pytest.approx(0.4)
    assert got["careless.adam"] == pytest.approx(0.2)
    assert "careless.sync" not in got and "careless.chunk" not in got
    assert spans.per_step_ms(_two_chunks()[:1]) == {}
    assert spans.last_chunk([("careless.step", 0.0, 1.0)]) == []


def test_idle_goes_to_the_innermost_span_and_sums_to_the_gaps():
    s = _two_chunks()
    # device work with three gaps: 250-450 in step 0's elbo (0-400),
    # 820-880 in its first update range (800-860) before adam (900-1000),
    # and 3750-4150 between the chunks (3700 and 4200)
    device = [(0, 250), (450, 820), (880, 3750), (4150, 4400)]
    idle = dict(spans.idle_by_span(s, device))
    assert idle == pytest.approx({"careless.elbo": 200e-6,
                                  "careless.update": 60e-6,
                                  spans.OUTSIDE: 400e-6})
    total = float((trace.idle_gaps(device)[:, 1]
                   - trace.idle_gaps(device)[:, 0]).sum()) / 1e6
    assert sum(idle.values()) == pytest.approx(total)
    line = spans.idle_line(spans.idle_by_span(s, device))
    assert line.startswith("idle by span: outside any span 0.000400 s "
                           "(60.61 %), careless.elbo 0.000200 s")
    assert line.endswith(f"total {total:.6f} s")


def test_event_spans_are_the_host_ranges():
    """The device's copy of a range (a user annotation on the card) and
    the operations are left out."""
    from torch.autograd import DeviceType

    def event(name, device, start, end, annotation=True):
        return types.SimpleNamespace(
            name=name, device_type=device, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(start=start, end=end))
    got = spans.event_spans([
        event("careless.step", DeviceType.CPU, 0.0, 10.0),
        event("careless.step", DeviceType.CUDA, 2.0, 12.0),
        event("careless.elbo", DeviceType.CPU, 1.0, 4.0),
        event("aten::mul", DeviceType.CPU, 1.0, 2.0, annotation=False),
        event("other", DeviceType.CPU, 0.0, 1.0)])
    assert got == [("careless.step", 0.0, 10.0),
                   ("careless.elbo", 1.0, 4.0)]


def test_gap_in_adam_goes_to_adam():
    s = _two_chunks()
    assert spans.innermost(s, 950) == "careless.adam"
    assert spans.innermost(s, 3750) is None


def _run(traced=True):
    return types.SimpleNamespace(trace={} if traced else None)


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_spans(monkeypatch, name):
    monkeypatch.setattr(program, "RECORDED", [])
    assert spec.reader(name)(_run()) is None
    monkeypatch.setattr(program, "RECORDED", [
        program.Span(n, int(lo * 1e3), int(hi * 1e3))
        for n, lo, hi in _two_chunks()])
    assert spec.reader(name)(_run(traced=False)) is None


@pytest.mark.parametrize("name,want", [
    ("host_ms_per_step", 2.0), ("host_ms_per_step.host_paced", 2.0),
    ("elbo_host_ms", 0.8), ("backward_host_ms", 0.8),
    ("update_host_ms", 0.4)])
def test_readers_read_the_program_record(monkeypatch, name, want):
    monkeypatch.setattr(program, "RECORDED", [
        program.Span(n, int(lo * 1e3), int(hi * 1e3))
        for n, lo, hi in _two_chunks()])
    assert spec.reader(name)(_run()) == pytest.approx(want)


def test_readers_none_where_the_program_keeps_no_record(monkeypatch):
    """The parent's program has no spans module: nothing, and no raise."""
    import builtins
    real = builtins.__import__

    def refuse(name, *args, **kwargs):
        if name == "careless_tpu_torch.utils" and "spans" in (args[2] or ()):
            raise ImportError(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", refuse)
    assert spans.program_spans() == []
    for name in READERS:
        assert spec.reader(name)(_run()) is None


def test_idle_by_span_tool_reads_the_last_session(monkeypatch):
    """tools/idle_by_span.py keeps the run's last torch.profiler session
    and reads the careless.* ranges of its last chunk (here a stand-in
    run of two 2-step chunks on the CPU, which has no device records)."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity

    from careless_tpu_torch.utils.spans import span
    from portbench import run

    def stand_in(argv):
        assert argv[-2:] == ["--trace", "1"]
        with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
            for first in (0, 2):
                with span("careless.chunk", first):
                    for i in (first, first + 1):
                        with span("careless.step", i):
                            with span("careless.elbo"):
                                torch.ones(8).sum()
        return 0
    monkeypatch.setattr(run, "main", stand_in)
    path = spec.ROOT / "tools" / "idle_by_span.py"
    loaded = importlib.util.spec_from_file_location("idle_by_span", path)
    tool = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(tool)
    plain = torch.profiler.profile
    rc, idle, per_step = tool.traced(["--workload", "mono-10M"])
    assert torch.profiler.profile is plain
    assert rc == 0 and idle == []
    assert set(per_step) == {"careless.step", "careless.elbo"}
    assert 0 < per_step["careless.elbo"] <= per_step["careless.step"]

"""The training loop's spans (careless_tpu_torch/utils/spans.py) on the CPU.

Under torch.profiler a 3-step merge in chunks of 2 (mono, mono through K4's
plain path, Laue) shows 2 careless.chunk and 3 careless.step ranges, in
each step one careless.elbo (with one surrogate, scaler, likelihood and kl
each) and careless.backward, then two careless.update ranges (the gradient
transform, then .grad and careless.adam), nested by time on one thread,
and one careless.sync a chunk; record_function is given the steps' indices
and the chunks' first steps, and the program's record of the spans names
what the profiler's trace names. Validation, checkpoints,
a sharded step's all_reduce and the crossvalidation loop take their own
spans. With no profiler running, span returns the shared null context and
record_function is never entered; a profiler session changes no number of
the merge.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from careless_tpu_torch.device import seeded_generator
from careless_tpu_torch.io.manager import DataManager
from careless_tpu_torch.models.base import Inputs
from careless_tpu_torch.models.merging.variational import flatten_params
from careless_tpu_torch.parallel import distributed
from careless_tpu_torch.parallel.shard import shard_inputs
from careless_tpu_torch.parallel.xval import stack_halves, train_halves
from careless_tpu_torch.utils import spans
from chip_smoke import MONO_DEFAULTS, build_problem

torch.set_num_threads(2)

KINDS = {"mono": (False, "off"), "mono_fused": (False, "on"),
         "laue": (True, "off")}
STEP_PARTS = ("careless.elbo", "careless.backward", "careless.update")
STEP_ARGS = ["0", "1", "2"]
ELBO_PARTS = ("careless.surrogate", "careless.scaler", "careless.likelihood",
              "careless.kl")


def _manager(laue, fused="off", seed=3):
    arrays, asu, _ = build_problem(seed, 1200, 150, 6, 4, laue=laue)
    parser = types.SimpleNamespace(**{**MONO_DEFAULTS, "mlp_layers": 2,
                                      "seed": seed, "fused_kernel": fused})
    return DataManager(Inputs.from_arrays(*arrays, device="cpu"), asu,
                       parser, device="cpu")


def _merge(kind):
    laue, fused = KINDS[kind]
    dm = _manager(laue, fused)
    _, params, trainer = dm.build_model()
    rows = (dm.inputs.sorted_by_harmonic(dm.n_refl) if laue
            else dm.inputs.sorted_by_refl())
    return params, trainer, rows.with_plans(dm.n_refl, dm.n_images)


def _train(params, trainer, inputs, steps=3, **kw):
    return trainer.train(params, seeded_generator(0, "cpu"), inputs, steps,
                         chunk_size=2, device="cpu", **kw)


def _profiled(fn):
    """(fn's result, the profiler's careless.* ranges, each span name's
    args as record_function was given them, in order) of fn run under
    torch.profiler; spans.RECORDED holds this run's spans alone."""
    real, given = spans.record_function, {}

    def logged(name, args=None):
        given.setdefault(name, []).append(args)
        return real(name, args)
    spans.RECORDED.clear()
    spans.record_function = logged
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        spans.record_function = real
    ranges = [e for e in prof.events() if e.is_user_annotation
              and e.name.startswith("careless.")]
    return out, ranges, given


def _named(ranges, name):
    return sorted((r for r in ranges if r.name == name),
                  key=lambda r: r.time_range.start)


def _inside(ranges, outer, name):
    return [r for r in _named(ranges, name)
            if outer.time_range.start <= r.time_range.start
            and r.time_range.end <= outer.time_range.end]


@pytest.mark.parametrize("kind", list(KINDS))
def test_spans_of_a_merge(kind):
    params, trainer, inputs = _merge(kind)
    _, ranges, given = _profiled(lambda: _train(params, trainer, inputs))
    assert len({r.thread for r in ranges}) == 1
    chunks, steps = (_named(ranges, n) for n in ("careless.chunk",
                                                 "careless.step"))
    assert len(chunks) == 2 and len(steps) == 3
    for step in steps:
        parts = [_inside(ranges, step, n) for n in STEP_PARTS]
        # the update's time a step is its two ranges': the gradient
        # transform in step_gradients, then .grad and Adam
        assert [len(p) for p in parts] == [1, 1, 2]
        (elbo,), (backward,), updates = parts
        assert elbo.time_range.end <= backward.time_range.start
        assert all(backward.time_range.end <= u.time_range.start
                   for u in updates)
        assert [len(_inside(ranges, elbo, n)) for n in ELBO_PARTS] == [1] * 4
        assert [len(_inside(ranges, u, "careless.adam"))
                for u in updates] == [0, 1]
        assert not _inside(ranges, step, "careless.all_reduce")
    for chunk in chunks:
        (sync,) = _inside(ranges, chunk, "careless.sync")
        assert all(s.time_range.end <= sync.time_range.start
                   for s in _inside(ranges, chunk, "careless.step"))
    assert given["careless.step"] == STEP_ARGS
    assert given["careless.chunk"] == ["0", "2"]
    assert set(given["careless.elbo"]) == {None}
    recorded = list(spans.RECORDED)
    assert sorted(s.name for s in recorded) == sorted(r.name for r in ranges)
    assert all(s.start_ns <= s.end_ns for s in recorded)


def test_validation_and_checkpoint_take_spans(tmp_path):
    params, trainer, inputs = _merge("mono")
    _, ranges, _ = _profiled(lambda: _train(
        params, trainer, inputs, validation_data=inputs,
        validation_frequency=2, checkpoint_path=str(tmp_path / "ckpt"),
        checkpoint_frequency=3))
    chunks = _named(ranges, "careless.chunk")
    assert [len(_inside(ranges, c, "careless.validation"))
            for c in chunks] == [1, 1]
    assert [len(_inside(ranges, c, "careless.checkpoint"))
            for c in chunks] == [0, 1]
    # the held-out NLL's ELBO lies in the validation span, not in a step
    (v,) = _inside(ranges, chunks[0], "careless.validation")
    assert len(_inside(ranges, v, "careless.likelihood")) == 1
    assert len(_named(ranges, "careless.elbo")) == 3


def test_sharded_step_spans_its_all_reduce(tmp_path):
    dm = _manager(False)
    _, params, trainer = dm.build_model()
    distributed.initialize("gloo", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        inputs, shard = shard_inputs(dm.inputs.sorted_by_refl(), 0, 1,
                                     dm.n_refl, dm.n_images)
        _, ranges, _ = _profiled(lambda: _train(params, trainer, inputs, 2,
                                                shard=shard))
    finally:
        torch.distributed.destroy_process_group()
    for step in _named(ranges, "careless.step"):
        updates = _inside(ranges, step, "careless.update")
        assert [len(_inside(ranges, u, "careless.all_reduce"))
                for u in updates] == [1, 0]
        assert [len(_inside(ranges, u, "careless.adam"))
                for u in updates] == [0, 1]


@pytest.mark.parametrize("laue", [False, True], ids=["mono", "laue"])
def test_train_halves_takes_the_same_spans(laue):
    dm = _manager(laue)
    _, params, trainer = dm.build_model()
    trainer = dataclasses.replace(trainer, freeze=("scaler",))
    halves = dm.split_data_by_image()
    stacked = stack_halves([dm.planned_rows(h).inputs for h in halves],
                           dm.n_refl, dm.n_images)
    _, ranges, given = _profiled(lambda: train_halves(
        trainer, params, [5, 6], stacked, 3, chunk_size=2, device="cpu"))
    assert len(_named(ranges, "careless.chunk")) == 2
    steps = _named(ranges, "careless.step")
    assert len(steps) == 3
    for step in steps:
        assert [len(_inside(ranges, step, n))
                for n in STEP_PARTS] == [1, 1, 1]
    assert len(_named(ranges, "careless.sync")) == 2
    assert given["careless.step"] == STEP_ARGS


def test_no_profiler_no_record_function(monkeypatch):
    """Off: the shared nullcontext, no record_function, nothing recorded."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(spans, "record_function", refuse)
    spans.RECORDED.clear()
    assert spans.span("careless.step", 0) is spans.span("careless.elbo")
    assert isinstance(spans.span("careless.chunk"), type(spans._OFF))
    params, trainer, inputs = _merge("mono")
    _, history = _train(params, trainer, inputs, 2)
    assert len(history["loss"]) == 2 and not spans.RECORDED


@pytest.mark.parametrize("kind", ["mono", "laue"])
def test_profiler_changes_no_number(kind):
    params, trainer, inputs = _merge(kind)
    plain, hist = _train(params, trainer, inputs)
    (traced, traced_hist), _, _ = _profiled(
        lambda: _train(params, trainer, inputs))
    assert traced_hist == hist
    for (path, a), (_, b) in zip(flatten_params(plain),
                                 flatten_params(traced)):
        assert torch.equal(a, b), path
    assert np.isfinite(hist["loss"]).all()

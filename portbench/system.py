"""Everything the benchmark does with the system under test,
careless_tpu_torch: the model built as the CLI builds it, the rows laid
out and planned, the first steps read out for the comparison, the timed
call, and the gathers' sizes recorded in a traced window."""
from __future__ import annotations

import contextlib
import inspect
import time
import types
from typing import NamedTuple

import torch

from . import counts
from .correct import leaves
from .peaks import bound


class Built(NamedTuple):
    params: dict
    trainer: object
    inputs: object


def build(problem, config: dict, device, times: dict) -> Built:
    """The initial params and trainer from DataManager.build_model
    under the configuration's CLI flags, and the rows of the training
    layout with their plans; `times` gets the host seconds of each part."""
    from careless_tpu_torch.io.manager import DataManager
    from careless_tpu_torch.models.base import Inputs

    def lap(name, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        times[name] = t1 - t0
        return t1

    t = time.perf_counter()
    inputs = Inputs.from_arrays(*problem.arrays, device=device)
    t = lap("inputs_s", t)
    dm = DataManager(inputs, problem.asu,
                     types.SimpleNamespace(**config["cli"]), device=device)
    _, params, trainer = dm.build_model()
    t = lap("model_s", t)
    rows = (inputs.sorted_by_harmonic(dm.n_refl) if inputs.is_laue
            else inputs.sorted_by_refl())
    t = lap("layout_s", t)
    rows = rows.with_plans(dm.n_refl, dm.n_images)
    lap("plans_s", t)
    return Built(params, trainer, rows)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def first_steps(built: Built, seed: int, steps: int, chunk: int,
                device) -> dict:
    """The merge driven from the seed of its generator through `steps`
    steps by the timed call itself: {trained (its nested params), losses,
    grads (step 1's, as Adam took
    them: its first moment after one step over 1 - beta_1), params0,
    params}."""
    trainer = built.trainer
    make = trainer.optimizer
    moments = []

    def optimizer(leaf_list):
        opt = make(leaf_list)

        def after(o, args, kwargs):
            if not moments:
                moments.extend(o.state[p]["exp_avg"].clone()
                               for p in leaf_list)
        opt.register_step_post_hook(after)
        return opt

    trainer.optimizer = optimizer
    try:
        params, history = trainer.train(built.params, generator(seed, device),
                                        built.inputs, steps, chunk_size=chunk,
                                        device=device)
    finally:
        del trainer.optimizer
    names = [k for k, _ in leaves(built.params)]
    return dict(trained=params, losses=list(history["loss"]),
                grads={k: m / (1.0 - trainer.beta_1)
                       for k, m in zip(names, moments)},
                params0=dict(leaves(built.params)),
                params=dict(leaves(params)))


def timed(built: Built, params: dict, seed: int, steps: int, chunk: int,
          device):
    """(params, history, wall seconds) of one Trainer.train call, as the
    CLI makes it, to its last chunk's synchronise."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out, history = built.trainer.train(params, generator(seed, device),
                                       built.inputs, steps, chunk_size=chunk,
                                       device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, history, time.perf_counter() - t0


# the K1 launchers of an f32 scaler with a head, by direction
K1_F32 = {"trunk_fwd": "fwd", "trunk_bwd": "bwd", "trunk_wide_fwd": "fwd",
          "trunk_wide_bwd": "bwd"}


def k1_bound(launched: dict, n: int, d_in: int, width: int, n_layers: int,
             peak_flops: float, peak_bw: float):
    """Seconds: the roofline bound of the K1 launches that `launched` (the
    port's launch counters) counts, each over all n rows of the scaler's
    input (d_in metadata columns, which take no gradient), at the
    configuration's width and depth; None where another K1 launcher (bf16,
    trunk only) ran, whose shapes these sizes do not give."""
    if any(v for k, v in launched.items()
           if k.startswith("trunk") and k not in K1_F32):
        return None
    per = {"fwd": counts.trunk_fwd(n, d_in, width, n_layers),
           "bwd": counts.trunk_bwd(n, d_in, width, n_layers)}
    return sum(launched.get(k, 0)
               * bound(*per[way], peak_flops, peak_bw)[0]
               for k, way in K1_F32.items())


# the gather launchers (K2, K5), with the names of their table and id
# parameters
GATHERS = {"gather": ("table", "ids"), "gather_stream": ("table", "ids2d")}


@contextlib.contextmanager
def recorded_gathers():
    """[(ids, table entries)] of every K2 and K5 launch made inside the
    block, read by parameter name as each launcher is called. A launcher
    without those parameters is left as it is and records nothing."""
    from careless_tpu_torch import kernels

    sizes = []

    def wrap(fn, table, ids):
        names = list(inspect.signature(fn).parameters)
        if table not in names or ids not in names:
            return fn
        ti, ii = names.index(table), names.index(ids)

        def launcher(*args, **kwargs):
            t = args[ti] if len(args) > ti else kwargs[table]
            i = args[ii] if len(args) > ii else kwargs[ids]
            sizes.append((i.numel(), t.numel()))
            return fn(*args, **kwargs)
        return launcher

    kept = {name: getattr(kernels, name) for name in GATHERS}
    for name, fn in kept.items():
        setattr(kernels, name, wrap(fn, *GATHERS[name]))
    try:
        yield sizes
    finally:
        for name, fn in kept.items():
            setattr(kernels, name, fn)

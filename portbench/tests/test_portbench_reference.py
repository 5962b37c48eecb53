"""The harness driven on the CPU at a tiny size, without its look for a
card: the port's plain CPU path against the reference is correct; the
reference in TF32 (the control) and the port broken underneath (a step
that leaves its state unchanged; half of the batch left out, the rest's
sum doubled) are not. A run on the card is marked `cuda` and skips here."""
import json
import subprocess
import sys
import types

import pytest
import torch

from portbench import correct, run, spec
from portbench.problem import build_problem
from portbench.reference import merge

TINY = {"observations": 6000, "reflections": 300, "images": 12}
CELLS = ("mono-10M", "laue-10M")


def cpu_run(cell, capsys, seed=2 ** 31 + 7):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5"], device=torch.device("cpu"), traffic=TINY)
    out = capsys.readouterr()
    assert rc == 0, out.err
    lines = out.err.strip().splitlines()
    assert lines[-1].startswith("compared failed_steps")
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys):
    result = cpu_run(cell, capsys)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = spec.cell(cell)
    problem = build_problem(11, TINY["observations"], TINY["reflections"],
                            TINY["images"], c.config["metadata_keys"],
                            laue=c.config["mode"] == "poly")
    ref = merge.Reference(problem, c.config, torch.device("cpu"))
    values = correct.readings(ref.run(5, tf32=True), ref.run(5))
    assert not correct.judge(values, c.settings["limits"]), values


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-3])
    got = merge.round_tf32(x)
    assert got.tolist()[:3] == [1.0, 1.0, 1.0 + 2 ** -9]
    assert abs(got[3] / x[3] - 1) < 2 ** -11


@pytest.mark.parametrize("cell", CELLS)
def test_unchanged_state_is_not_correct(cell, capsys, monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, *args, **kwargs):
        kept = [p.detach().clone() for g in self.param_groups
                for p in g["params"]]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, k in zip((p for g in self.param_groups
                             for p in g["params"]), kept):
                p.copy_(k)
        return out
    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)
    result = cpu_run(cell, capsys)
    assert not result["correct"]
    assert result["compared"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_is_not_correct(cell, capsys, monkeypatch):
    from careless_tpu_torch.models.merging.variational import \
        VariationalMergingModel as Model

    def half(likelihood, ipred):
        rows = (likelihood.masked_ll_rows(ipred)
                if hasattr(likelihood, "masked_ll_rows")
                else likelihood.log_prob(ipred))
        return 2.0 * torch.sum(rows[..., 0::2])
    monkeypatch.setattr(Model, "_masked_ll_sum", staticmethod(half))
    result = cpu_run(cell, capsys)
    assert not result["correct"]
    assert result["compared"]["loss_gap"]["value"] \
        > result["compared"]["loss_gap"]["limit"]


def test_jax_loaded_by_the_reference_gives_no_result(capsys, monkeypatch):
    """JAX loaded as late as the reference's own steps: exit 3, and no
    result on standard output."""
    follow = merge.Reference.run

    def loads_jax(self, *args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return follow(self, *args, **kwargs)
    monkeypatch.setattr(merge.Reference, "run", loads_jax)
    rc = run.main(["--workload", "mono-10M", "--seed", "5", "--seconds",
                   "0.5"], device=torch.device("cpu"), traffic=TINY)
    out = capsys.readouterr()
    assert rc == 3
    assert out.out == ""
    assert "jax" in out.err.strip().splitlines()[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mono-10M"])
def test_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "1"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0

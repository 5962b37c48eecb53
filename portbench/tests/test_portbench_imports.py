"""No run loads JAX or the JAX package, compared by whole top-level names
(careless_tpu_torch begins with careless_tpu), and the reference loads
nothing of the port."""
import subprocess
import sys

from portbench import run, spec

PROBE = """
import sys
{imports}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def top_level(imports):
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        imports=imports)], cwd=spec.ROOT, capture_output=True, text=True,
        check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    found = top_level("import portbench.run, portbench.calibrate\n"
                      "import careless_tpu_torch.io.manager\n"
                      "import careless_tpu_torch.models.base\n"
                      "import careless_tpu_torch.kernels\n"
                      "import torch.profiler")
    assert "careless_tpu_torch" in found
    assert not found & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    found = top_level("import portbench.reference.merge")
    assert not found & ({"careless_tpu_torch"} | set(run.FORBIDDEN))


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "careless_tpu_torch_x", sys)
    assert "careless_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "careless_tpu.sub", sys)
    assert run.loaded_forbidden() == ["careless_tpu"]


def test_no_card_no_result():
    """A run where torch finds no card exits 2 and prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "mono-10M",
         "--seed", "3", "--seconds", "1"], cwd=spec.ROOT,
        capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                             "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2
    assert out.stdout == ""

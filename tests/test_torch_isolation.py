"""careless_tpu_torch, chip_smoke.py and the port's tools (tools/*.py, which
run on the card beside it) import neither JAX, optax, pandas, seaborn
(which imports pandas) nor the JAX package (careless_tpu itself or any
careless_tpu.* module). Checked twice:
statically over every import statement, and by importing every module in a
fresh interpreter and inspecting sys.modules. Importing every module also
loads no matplotlib, which the card's machine lacks: the statistics tools
import it only to draw a plot that was asked for.

Note "careless_tpu_torch".startswith("careless_tpu"): the JAX package is
matched as the exact name or the prefix "careless_tpu.", never as a bare
string prefix.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOOLS = sorted((ROOT / "tools").glob("*.py"))
PORT_FILES = sorted((ROOT / "careless_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + TOOLS


def forbidden(module: str) -> bool:
    for name in ("jax", "jaxlib", "optax", "pandas", "seaborn",
                 "careless_tpu"):
        if module == name or module.startswith(name + "."):
            return True
    return False


def test_forbidden_matches_modules_not_prefixes():
    assert forbidden("careless_tpu") and forbidden("careless_tpu.ops.x")
    assert forbidden("jax.numpy") and forbidden("optax")
    assert forbidden("pandas") and forbidden("pandas.core.frame")
    assert forbidden("seaborn") and forbidden("seaborn.relational")
    assert not forbidden("careless_tpu_torch")
    assert not forbidden("careless_tpu_torch.ops") and not forbidden("jaxy")


def test_no_forbidden_import_statements():
    assert len(PORT_FILES) > 15
    bad = []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = """
import importlib, importlib.util, json, pkgutil, sys
import careless_tpu_torch
for mod in pkgutil.walk_packages(careless_tpu_torch.__path__,
                                 "careless_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(path, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(sys.modules)))
"""
    assert ROOT / "tools" / "trunk_bwd_probe.py" in TOOLS
    out = subprocess.run([sys.executable, "-c", code, *map(str, TOOLS)],
                         cwd=ROOT, capture_output=True, text=True,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("io.manager", "kernels._build", "ops.fused_elbo",
                "models.likelihoods.mono", "models.merging.variational",
                "ops.chain_layout", "ops.conv_runs",
                "models.likelihoods.laue", "ops.fused_mlp",
                "models.scaling.nn", "models.scaling.image", "main",
                "parser", "io.formatter", "io.asu", "xtal.mtz",
                "xtal.dataset", "xtal.symmetry", "utils.checkpoint",
                "utils.positional_encoding", "utils.laue", "xtal.stream",
                "xtal.xds", "parallel.xval", "models.priors.double_wilson",
                "models.priors.empirical", "models.merging.surrogate",
                "stats._lib", "stats.cchalf", "stats.history",
                "scripts.to_intensities", "scripts.plot_predictions"):
        assert "careless_tpu_torch." + mod in loaded
    assert [m for m in loaded if forbidden(m)] == []
    assert [m for m in loaded if m == "matplotlib"
            or m.startswith("matplotlib.")] == []

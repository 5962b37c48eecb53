"""The double-Wilson prior's gain on a sparse, noisy child.

chip_smoke.prior_phase's two seeded MTZs (seed 0: a parent of PRIOR_OBS
observations; a child of PRIOR_CHILD_OBS observations with SIGI = 0.05 +
--child-sigma I, its true F drawn at r = PRIOR_R from the parent's),
merged by a CLI module in a subprocess: the pair coupled by
--double-wilson-parents=None,0 with r trained, then the child alone under
the Wilson prior, PRIOR_STEPS steps each. Prints one JSON line: the
parent's, the coupled child's and the lone child's merged-F correlation
with the true F, and r at the last step.

    python tools/prior_gain.py [--child-sigma S] [--cpu]
        [--module careless_tpu_torch.main]

--module takes any CLI with careless's flags: the reference package's
careless_tpu.main runs the same merges on the CPU (with JAX_PLATFORMS=cpu
in the environment).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child-sigma", type=float, default=cs.PRIOR_CHILD_SIGMA)
    ap.add_argument("--cpu", action="store_true",
                    help="pass --disable-gpu to the port's CLI")
    ap.add_argument("--module", default="careless_tpu_torch.main")
    args = ap.parse_args()

    from careless_tpu_torch.xtal import (DataSet, SpaceGroup, UnitCell,
                                         read_mtz, write_mtz)

    seed = 0
    parent = cs.synthetic_mtz(seed + 10, cs.PRIOR_OBS, cs.PRIOR_IMAGES,
                              cs.CLI_CELL, cs.CLI_SPACEGROUP, cs.PRIOR_DMIN)
    child = cs.synthetic_mtz(seed + 11, cs.PRIOR_CHILD_OBS, cs.PRIOR_IMAGES,
                             cs.CLI_CELL, cs.CLI_SPACEGROUP, cs.PRIOR_DMIN,
                             f_true=cs.child_f(seed + 12, parent[2],
                                               cs.PRIOR_R),
                             rel_sigma=args.child_sigma)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    common = [f"--iterations={cs.PRIOR_STEPS}", "--disable-progress-bar",
              f"--seed={seed}"] + (["--disable-gpu"] if args.cpu else [])
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        files = []
        for name, ((cols, types_), _, _) in (("parent", parent),
                                            ("child", child)):
            files.append(str(Path(tmp) / f"{name}.mtz"))
            write_mtz(DataSet(cols, cell=UnitCell(*cs.CLI_CELL),
                              spacegroup=SpaceGroup.from_name(
                                  cs.CLI_SPACEGROUP), mtz_dtypes=types_),
                      files[-1])
        cli = [sys.executable, "-m", args.module, "mono", cs.CLI_KEYS]
        out, alone = str(Path(tmp) / "dw"), str(Path(tmp) / "alone")
        subprocess.run(cli + files + [out] + common + [
            "--separate-files", "--double-wilson-parents=None,0",
            "--double-wilson-r=0.,0.9", "--optimize-double-wilson-r"],
            env=env, check=True, stdout=subprocess.DEVNULL)
        subprocess.run(cli + [files[1], alone] + common, env=env, check=True,
                       stdout=subprocess.DEVNULL)
        merged = [read_mtz(f"{out}_{i}.mtz") for i in range(2)]
        alone = read_mtz(alone + "_0.mtz")
        with open(out + "_history.csv") as f:
            lines = f.read().splitlines()
    column = lines[0].split(",").index("rDW_1")
    print(json.dumps(dict(
        module=args.module, child_sigma=args.child_sigma,
        cc_parent=cs.cc_true_f("parent", merged[0], parent[1], parent[2]),
        cc_child=cs.cc_true_f("child", merged[1], child[1], child[2]),
        cc_child_alone=cs.cc_true_f("child alone", alone, child[1],
                                    child[2]),
        rDW_1_last=float(lines[-1].split(",")[column]))))


if __name__ == "__main__":
    main()

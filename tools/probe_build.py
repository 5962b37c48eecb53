"""The probes' build steps (tools/trunk_bwd_probe.py,
tools/trunk_wide_probe.py, tools/trunk_fwd_probe.py): sources of csrc/
compiled alone with the port's nvcc flags (kernels/_build.py NVCC_FLAGS), all
nvcc processes at once, linked into a library, and ptxas' lines and the SASS
of the objects read back by kernel, with the instruction counts of their
loops."""
import ctypes
import re
import subprocess
from pathlib import Path

from careless_tpu_torch.kernels import _build


def compile_objects(jobs: dict) -> dict:
    """jobs: {object path: (source path, include dir)}; runs every nvcc at
    once and returns {object path: its log} (ptxas' lines among them);
    raises with the log of one that fails."""
    nvcc = _build._nvcc()
    procs = {}
    for obj, (src, include) in jobs.items():
        Path(obj).parent.mkdir(parents=True, exist_ok=True)
        procs[obj] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(include), "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs, failed = {}, None
    for obj, proc in procs.items():
        logs[obj], _ = proc.communicate()
        if proc.returncode and failed is None:
            failed = logs[obj]
    if failed is not None:
        raise RuntimeError(failed)
    return logs


def link(objs, so: Path) -> ctypes.CDLL:
    """The objects linked into the shared library `so`, loaded."""
    subprocess.run([_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-shared", "-o", str(so),
                    *map(str, objs)], check=True)
    return ctypes.CDLL(str(so))


def ptxas_lines(log: str, kernels: dict):
    """(label, line) for each kernel of `kernels` ({symbol fragment: label})
    that ptxas compiled in `log`: its function properties, registers and
    spills, joined on one line."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        for key, label in kernels.items():
            if key in line and "Compiling" in line:
                yield label, " | ".join(s.strip() for s in lines[i + 1:i + 4])


def sass(obj, kernels: dict) -> tuple:
    """The SASS of `obj` (cuobjdump -sass) and, for each kernel of
    `kernels` ({symbol fragment: label}) it holds, its instructions as
    (address, opcode, operands)."""
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(obj)], capture_output=True, text=True,
                          check=True).stdout
    code, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            current = next((v for k, v in kernels.items() if k in line),
                           None)
            if current:
                code[current] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z0-9.]+)([^;]*);", line)
        if current and m:
            code[current].append((int(m.group(1), 16), m.group(2),
                                  m.group(3)))
    return text, code


# the instructions sass_counts counts by opcode: shared-memory loads and
# stores, FMAs, barriers, async copies, device and generic loads and stores,
# local memory (spills)
COUNTED = ("LDS", "STS", "FFMA", "BAR", "LDGSTS", "LDG", "STG", "LD.", "LDL",
           "STL")


def sass_counts(obj, kernels: dict, out: Path, kinds=COUNTED, loops=6):
    """Instruction counts of each kernel of `kernels` ({symbol fragment:
    label}) in the SASS of `obj` (written whole to `out`), by opcode for
    those that start with one of `kinds`: over the whole kernel, and in
    its `loops` innermost loop bodies (from a backward branch's target to
    the branch) that hold FMAs, the most FMAs first, with the shared-memory
    wavefronts they need at least (4 a 16-byte load, 2 an 8-byte one, 1 a
    4-byte one, broadcast or not) per FMA. A generic load of shared memory
    shows as LD, not LDS, and counts as one. A loop body holds both sides
    of its branches (f32 and bf16 operands), so a load on each side counts
    twice."""
    text, code = sass(obj, kernels)
    Path(out).write_text(text)

    def mix(ins, lo, hi):
        c = {}
        for addr, op, _ in ins:
            if lo <= addr <= hi and op.startswith(kinds):
                c[op] = c.get(op, 0) + 1
        c["instructions"] = sum(1 for a, _, _ in ins if lo <= a <= hi)
        waves = sum(n * (4 if op.endswith(".128") else
                         2 if op.endswith(".64") else 1)
                    for op, n in c.items() if op.startswith(("LDS", "LD.")))
        c["lds_wavefronts_per_ffma"] = (waves / c["FFMA"] if c.get("FFMA")
                                        else None)
        return c

    counts = {}
    for kernel, ins in code.items():
        bodies = []
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and target and int(target.group(1), 16) < addr:
                bodies.append(mix(ins, int(target.group(1), 16), addr))
        # innermost: the bodies with FMAs, fewest instructions first
        bodies = sorted((c for c in bodies if c.get("FFMA")),
                        key=lambda c: c["instructions"])
        counts[kernel] = dict(whole=mix(ins, 0, 1 << 62), loop_bodies=sorted(
            bodies[:loops], key=lambda c: -c["FFMA"]))
    return counts

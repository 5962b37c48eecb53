"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

Every `csrc/*.cu` is compiled for `sm_90a` by its own `nvcc` process, all
started together (the headers `csrc/*.cuh` are included, not compiled), and
the objects are linked into one shared library with a plain C interface.
The library lands in `build/careless_tpu_torch/<hash>/` at the root of the
checkout, where `<hash>` covers the sources, the headers and the flags, so
an edit to any of them rebuilds at the next first use.
Only sources in the repository are compiled. A failed build raises: there is
no path on which a CUDA tensor falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "careless_tpu_torch"
LIB_NAME = "libcareless_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if the current sources have no library yet;
    returns the library's path. The compiler's output (registers, shared
    memory, spills from `-Xptxas -v`) is kept in `build.log` beside it."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        tmp = Path(tmp)
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp / LIB_NAME), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        try:
            tmp.rename(out_dir)
        except OSError:
            # another process finished the same build first
            if not lib.exists():
                raise
    return lib


@functools.cache
def library() -> "ctypes.CDLL":
    """The loaded kernel library (built on first call)."""
    path = build()
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    U32, U64, I64 = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_longlong
    signatures = {
        # x, w, b, out0, out1, n, d_in, width, n_layers, head, out_w, bf16,
        # n_blocks, leak, stream
        "ct_trunk_fwd": [P] * 5 + [I] * 8 + [F, P],
        # x, w, b, dy0, dy1, dx, part, out, n, d_in, width, n_layers, head,
        # out_w, bf16, tile, n_blocks, leak, stream
        "ct_trunk_bwd": [P] * 8 + [I] * 9 + [F, P],
        # x, w, b, dy0, dy1, dx, part, out, n, d_in, width, n_layers, head,
        # out_w, tile, n_blocks, leak, stream
        "ct_trunk_bwd_f32": [P] * 8 + [I] * 8 + [F, P],
        # as ct_trunk_bwd_f32
        "ct_trunk_bwd_bf16": [P] * 8 + [I] * 8 + [F, P],
        # x, w, b, out0, out1, n, d_in, width, n_layers, head, out_w, bf16,
        # leak, stream
        "ct_trunk_wide_fwd": [P] * 5 + [I] * 7 + [F, P],
        # x, w, b, dy0, dy1, dx, part, stash, out, n, d_in, width, n_layers,
        # head, out_w, bf16, n_blocks, leak, stream
        "ct_trunk_wide_bwd": [P] * 9 + [I] * 8 + [F, P],
        # table, ids, out, n, stream
        "ct_gather": [P, P, P, I, P],
        # table, t, ids, bases, out, n_tiles, tile, window, stream
        "ct_gather_stream": [P, I64, P, P, P, I, I, I, P],
        # out, bits, n, seed_lo, seed_hi, offset, stream
        "ct_philox_normal": [P, P, I, U32, U32, U64, P],
        # loc, scale, a, f, iobs, sig, mask, noise, ev, part, out, n,
        # n_parts, kind, dof, t_const, seed_lo, seed_hi, offset, stream
        "ct_fused_ll_fwd": [P] * 11 + [I, I, I, F, F, U32, U32, U64, P],
        # loc, scale, a, f, iobs, sig, mask, noise, ev, ct, dloc, dscale,
        # da, df, part, dev, n, kind, dof, t_const, seed_lo, seed_hi,
        # offset, stream
        "ct_fused_ll_bwd": [P] * 16 + [I, I, F, F, U32, U32, U64, P],
        # n, sm_count
        "ct_fused_ll_parts": [I, I],
        # n
        "ct_fused_ll_bwd_parts": [I],
        # out: (2,) uint32 host memory
        "ct_fused_ll_tickets": [P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # d_in, width, n_layers, head, tile (0: the forward)
    lib.ct_trunk_smem.argtypes = [I, I, I, I, I]
    lib.ct_trunk_smem.restype = ctypes.c_size_t
    lib.ct_trunk_fwd_rows.argtypes = [I]   # width
    # out: the forward's warps a block, warps a SM
    lib.ct_trunk_fwd_limits.argtypes = [P, P]
    lib.ct_trunk_fwd_limits.restype = None
    # d_in, width, n_layers, head, tile
    lib.ct_trunk_bwd_f32_smem.argtypes = [I, I, I, I, I]
    lib.ct_trunk_bwd_f32_smem.restype = ctypes.c_size_t
    lib.ct_trunk_bwd_bf16_smem.argtypes = [I, I, I, I, I]
    lib.ct_trunk_bwd_bf16_smem.restype = ctypes.c_size_t
    lib.ct_trunk_wide_smem.argtypes = [I, I, I]   # d_in, width, bwd
    lib.ct_trunk_wide_smem.restype = ctypes.c_size_t
    lib.ct_gather_stream_smem.argtypes = [I]   # window
    lib.ct_gather_stream_smem.restype = ctypes.c_size_t
    lib.ct_error_string.argtypes = [I]
    lib.ct_error_string.restype = ctypes.c_char_p
    return lib

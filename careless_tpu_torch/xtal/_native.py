"""ctypes binding of the port's C++ CrystFEL stream parser.

Counterpart of careless_tpu/xtal/_native.py, with its contract:
parse_stream(path) -> (arrays, cell), the same 14 columns and dtypes and the
same ValueError messages. The parser is this package's cpp/stream_parser.cc,
compiled at its first use (never at import) by the host C++ compiler ($CXX,
else c++, else g++) with the JAX package's cpp/Makefile flags into
build/careless_tpu_torch/<hash>/ at the root of the checkout. <hash> covers
the source, the flags, the compiler and its --version, and the host CPU as
the compiler sees it under -march=native (its predefined macros), since
-march=native code may not run on another CPU. Each build goes into a
temporary directory that is renamed into place, so processes that build at
once (the ranks of --num-devices) do not collide.

Where no compiler is found, parse_stream raises NoCompiler and read_crystfel
takes the Python reader. Where the compiler fails, RuntimeError carries its
output: there is no quiet fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shlex
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "cpp" / "stream_parser.cc"
BUILD_ROOT = SOURCE.parent.parent.parent / "build" / "careless_tpu_torch"
LIB_NAME = "libstream_parser.so"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]

_lib: Optional[ctypes.CDLL] = None


class NoCompiler(RuntimeError):
    """No host C++ compiler was found to build the parser."""


def compiler() -> Optional[List[str]]:
    """The host C++ compiler's command ($CXX, else c++, else g++), or None
    where none of them is found."""
    names = [os.environ["CXX"]] if os.environ.get("CXX") else []
    for cmd in [shlex.split(n) for n in names] + [["c++"], ["g++"]]:
        found = shutil.which(cmd[0]) if cmd else None
        if found:
            return [found, *cmd[1:]]
    return None


def _output(cmd: List[str], stdin: Optional[str] = None) -> str:
    proc = subprocess.run(cmd, input=stdin, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return f"rc {proc.returncode}\n{proc.stdout}"


def _digest(cxx: List[str]) -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (" ".join(CXX_FLAGS), " ".join(cxx),
                 _output([*cxx, "--version"]),
                 # the CPU's features as -march=native resolves them
                 _output([*cxx, "-march=native", "-dM", "-E", "-x", "c++",
                          "-"], stdin=""),
                 platform.machine()):
        h.update(part.encode())
    return h.hexdigest()[:16]


def build(cxx: List[str]) -> Path:
    """Compile the parser with `cxx` unless this source, compiler and CPU
    have a library already; returns the library's path. The compiler's
    output is kept in `build.log` beside it."""
    out_dir = BUILD_ROOT / _digest(cxx)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        tmp = Path(tmp)
        cmd = [*cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native stream parser failed (rc "
                f"{proc.returncode}): {shlex.join(cmd)}\n{proc.stdout}")
        (tmp / "build.log").write_text(shlex.join(cmd) + "\n" + proc.stdout)
        try:
            tmp.rename(out_dir)
        except OSError:
            # another process finished the same build first
            if not lib.exists():
                raise
    return lib


def library() -> ctypes.CDLL:
    """The loaded parser library (built at the first call); NoCompiler
    where no compiler is found."""
    global _lib
    if _lib is not None:
        return _lib
    cxx = compiler()
    if cxx is None:
        raise NoCompiler("no host C++ compiler ($CXX, c++ or g++) found: "
                         "the native stream parser cannot be built")
    lib = ctypes.CDLL(str(build(cxx)))
    lib.stream_parse.restype = ctypes.c_void_p
    lib.stream_parse.argtypes = [ctypes.c_char_p]
    lib.stream_n_refl.restype = ctypes.c_int64
    lib.stream_n_refl.argtypes = [ctypes.c_void_p]
    lib.stream_hkl.restype = ctypes.POINTER(ctypes.c_int32)
    lib.stream_hkl.argtypes = [ctypes.c_void_p]
    lib.stream_cols.restype = ctypes.POINTER(ctypes.c_float)
    lib.stream_cols.argtypes = [ctypes.c_void_p]
    lib.stream_cell.restype = ctypes.POINTER(ctypes.c_double)
    lib.stream_cell.argtypes = [ctypes.c_void_p]
    lib.stream_error.restype = ctypes.c_char_p
    lib.stream_error.argtypes = [ctypes.c_void_p]
    lib.stream_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def parse_stream(path: str) -> Tuple[dict, Optional[list]]:
    """Parse a CrystFEL stream with the native parser (built at the first
    call). Returns (the stream reader's 14 columns, the header's cell
    parameters or None)."""
    lib = library()
    handle = lib.stream_parse(path.encode())
    try:
        err = lib.stream_error(handle)
        if err:
            raise ValueError(err.decode())
        n = lib.stream_n_refl(handle)
        hkl = np.ctypeslib.as_array(lib.stream_hkl(handle),
                                    shape=(n, 3)).copy()
        cols = np.ctypeslib.as_array(lib.stream_cols(handle),
                                     shape=(n, 11)).copy()
        cell_ptr = lib.stream_cell(handle)
        cell = list(np.ctypeslib.as_array(cell_ptr, shape=(6,))) if cell_ptr \
            else None
    finally:
        lib.stream_free(handle)

    arrays = {
        "H": hkl[:, 0], "K": hkl[:, 1], "L": hkl[:, 2],
        "I": cols[:, 0], "SigI": cols[:, 1],
        "BATCH": cols[:, 2].astype(np.int32),
        "s1x": cols[:, 3], "s1y": cols[:, 4], "s1z": cols[:, 5],
        "ewald_offset": cols[:, 6],
        "angular_ewald_offset": cols[:, 7],
        "XDET": cols[:, 8], "YDET": cols[:, 9],
        "Wavelength": cols[:, 10],
    }
    return arrays, cell

"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``.cu`` source has a plain C interface and becomes its own shared
library, compiled by one ``nvcc`` per source, all started together, for
``sm_90a``; the libraries are loaded with ``ctypes``.  The build happens at
first use in ``csrc/build/<key>/`` (listed in ``.gitignore``), where ``key``
hashes the sources, the generated constants header and the flags, so a
changed source rebuilds and an unchanged one is reused.

The E2AFS datapath's integer constants are not rounded in C++: this module
writes them into ``e2afs_constants.h`` from
:func:`repro_torch.core.e2afs.format_constants`, the same numbers the plain
version uses.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

from repro_torch.core import numerics
from repro_torch.core.e2afs import format_constants

__all__ = ["BuildReport", "build", "constant", "function", "CSRC", "SOURCES"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = CSRC / "build"
SOURCES = ("e2afs_sqrt.cu", "rmsnorm.cu", "decode_attention.cu", "sobel.cu",
           "kmeans_assign.cu", "adam.cu")
HEADERS = ("e2afs.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildReport:
    directory: Path
    seconds: float  # wall time of this call's compiles (0.0 when reused)
    log: str  # nvcc's output, including the -Xptxas -v resource report
    libraries: dict  # source stem -> path of its shared library


_report: Optional[BuildReport] = None
_libs: dict = {}
_functions: dict = {}


def constants_header() -> str:
    lines = [
        "// Generated by repro_torch/kernels/_build.py from",
        "// repro_torch/core/e2afs.py::format_constants -- do not edit.",
        "#pragma once",
    ]
    for fmt in (numerics.FP16, numerics.BF16, numerics.FP32):
        c = format_constants(fmt)
        tag = fmt.name.upper()
        lines.append(f"#define E2AFS_{tag}_C_EVEN {c['c_even']}")
        lines.append(f"#define E2AFS_{tag}_C_ODD {c['c_odd']}")
        for (odd, y_hi), value in sorted(c["rsqrt_intercepts"].items()):
            lines.append(f"#define E2AFS_{tag}_RS_{odd}{y_hi} {value}")
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> BuildReport:
    """Compile every source that is not built yet (once per process)."""
    global _report
    if _report is not None:
        return _report
    header = constants_header()
    digest = hashlib.sha256(header.encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "e2afs_constants.h").write_text(header)

    libs = {Path(s).stem: out_dir / f"{Path(s).stem}.so" for s in SOURCES}
    todo = [s for s in SOURCES if not libs[Path(s).stem].exists()]
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"{Path(src).stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(out_dir), "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== nvcc {src} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, libs[Path(src).stem])
    text = "\n".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
    _report = BuildReport(out_dir, time.perf_counter() - t0 if todo else 0.0, text, libs)
    return _report


def _lib(stem: str) -> ctypes.CDLL:
    if stem not in _libs:
        _libs[stem] = ctypes.CDLL(str(build().libraries[stem]))
    return _libs[stem]


def constant(stem: str, symbol: str) -> int:
    """The value of ``extern "C" int symbol(void)`` of library ``stem``: a
    compile-time constant of its source, so Python keeps no copy of it."""
    fn = getattr(_lib(stem), symbol)
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return int(fn())


def function(stem: str, symbol: str, argtypes: Sequence) -> Callable:
    """A ctypes entry point of library ``stem`` that raises when the C side
    returns a CUDA error code (the launch's ``cudaGetLastError()``)."""
    key = (stem, symbol)
    if key in _functions:
        return _functions[key]
    lib = _lib(stem)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err = lib.repro_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p

    def call(*args):
        status = fn(*args)
        if status != 0:
            raise RuntimeError(f"{symbol}: CUDA error {status}: {err(status).decode()}")

    _functions[key] = call
    return call

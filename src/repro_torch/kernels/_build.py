"""Build and load the port's CUDA kernels (``csrc/fedback_kernels.cu``).

The source is compiled with ``nvcc`` into a shared library with a plain
C interface and loaded with ``ctypes`` — no PyTorch headers, so the
build takes seconds.  It runs at first use, never at import: the CPU
tests import every module on machines without ``nvcc``.  The library is
cached under ``build/kernels/<hash>/`` at the root of the checkout,
keyed by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once.  ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside the library in ``build.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fedback_kernels.cu"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libfedback_kernels.so"

_lib = None  # the loaded library, once built


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / digest / LIB_NAME


def build() -> Path:
    """Compile the library unless the cached one matches; returns its path."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        proc = subprocess.run(
            [nvcc_path(), *FLAGS, "-o", str(tmp_lib), str(SOURCE)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        (out.parent / "build.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp_lib, out)  # atomic: a reader sees all or nothing
    return out


def build_log() -> str:
    """nvcc's report from the build of the current source."""
    return (library_path().parent / "build.log").read_text()


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.fb_trigger_sq_norms.argtypes = [p, p, p, i64, i64, p]
        lib.fb_admm_update.argtypes = [p, p, p, p, p, p, i64, i64, i32, p]
        lib.fb_fused_gss.argtypes = [p, p, p, p, p, p, p, i64, i64, i64,
                                     i32, p]
        for fn in (lib.fb_trigger_sq_norms, lib.fb_admm_update,
                   lib.fb_fused_gss):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")

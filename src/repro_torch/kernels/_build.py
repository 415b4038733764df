"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source (``fedback_kernels.cu``: K1–K3, K1's leaf-table form and
K2's and K3's bf16 instances;
``model_kernels.cu``: K4, K5) is compiled by its own ``nvcc -c``, all
started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers,
so the build takes seconds.  It runs at first use, never at import: the CPU tests import
every module on machines without ``nvcc``.  The library is cached under
``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash
of every source and the flags, so an edited source rebuilds and an
unchanged tree loads at once.  ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the
library in ``build.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "fedback_kernels.cu", CSRC / "model_kernels.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
         "-v")
LIB_NAME = "librepro_torch_kernels.so"

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
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _nvcc_all(jobs: dict, tmp: Path) -> str:
    """Start one nvcc per {name: argv} at once, wait for all; raise if
    one failed; returns their reports."""
    procs = {}
    for name, argv in jobs.items():
        with open(tmp / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(argv, stdout=log,
                                           stderr=subprocess.STDOUT)
    codes = {name: proc.wait() for name, proc in procs.items()}
    reports = {name: (tmp / f"{name}.log").read_text() for name in jobs}
    for name, rc in codes.items():
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {name} ({rc}):\n"
                               f"{reports[name]}")
    return "\n".join(f"== {name}\n{text}" for name, text in reports.items())


def build() -> Path:
    """Compile the library unless the cached one matches; returns its path."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp = Path(tmp)
        objs = [tmp / (src.stem + ".o") for src in SOURCES]
        log = _nvcc_all({src.name: [nvcc, *FLAGS, "-c", "-o", str(obj),
                                    str(src)]
                         for src, obj in zip(SOURCES, objs, strict=True)},
                        tmp)
        tmp_lib = tmp / LIB_NAME
        log += "\n" + _nvcc_all({"link": [nvcc, *ARCH, "-shared", "-o",
                                          str(tmp_lib), *map(str, objs)]},
                                tmp)
        (out.parent / "build.log").write_text(log)
        os.replace(tmp_lib, out)  # atomic: a reader sees all or nothing
    return out


def build_log() -> str:
    """nvcc's report from the build of the current sources."""
    return (library_path().parent / "build.log").read_text()


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.fb_trigger_sq_norms.argtypes = [p, p, p, i64, i64, i32, i64,
                                            i32, p]
        lib.fb_trigger_sq_norms_table.argtypes = [p, i32, p, i32, i64, i32,
                                                  i64, p, p]
        lib.fb_admm_update.argtypes = [p, p, p, p, p, p, i64, i64, i32, p]
        lib.fb_fused_gss.argtypes = [p, p, p, p, p, p, p, i64, i64, i64,
                                     i32, i64, i32, i32, p]
        lib.fb_admm_update_bf16.argtypes = [p, p, p, p, p, p, i64, i64,
                                            i32, i32, p]
        lib.fb_fused_gss_bf16.argtypes = lib.fb_fused_gss.argtypes
        lib.mk_flash_attention.argtypes = ([p] * 6 + [i64] * 12 + [i64] * 5
                                           + [i32] * 3
                                           + [ctypes.c_float, p])
        lib.mk_ssd_scan.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, p]
        for fn in (lib.fb_trigger_sq_norms, lib.fb_trigger_sq_norms_table,
                   lib.fb_admm_update, lib.fb_admm_update_bf16,
                   lib.fb_fused_gss, lib.fb_fused_gss_bf16,
                   lib.mk_flash_attention,
                   lib.mk_ssd_scan):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")

"""Build, bind and count the flat-update CUDA kernels.

``load()`` compiles ``csrc/flat_update.cu`` with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, under
``build/repro_torch/`` at the repository root (listed in .gitignore).
The library name carries a hash of the source and the flags, so an
edited source builds anew and an unchanged one loads at once.  The
library is loaded with ``ctypes``; every pointer and the stream are
``c_void_p``.  A failed build raises: there is no fallback.

``LAUNCHES`` counts kernel launches per kernel name.  The wrappers add
one where they launch a kernel and nowhere else, so a run can show that
its main path went through the kernels (``reset_launches`` before it,
``launches`` after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "flat_update.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
# no --use_fast_math: both kernels need IEEE sqrtf and division;
# -fmad=false keeps a*b+c rounded twice, as the plain versions round it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES = {"flat_update_batch": 0, "send_view": 0}

_lib = None
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the flat "
                       "update kernels cannot be built")


def _library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libflat_update_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source's library exists; return
    its path.  Records the compile seconds and ptxas report in
    ``BUILD_INFO``."""
    out = _library_path()
    if out.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["ptxas"] = proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The bound kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.flat_update_batch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,   # buffers
            _LL, _I, _I,                              # rows, n, k
            _I, _I, _I, _F, _I, _I,                   # flags, dc_lambda
            _F, _F, _F,                               # b2, 1 - b2, eps
            _P]                                       # stream
        lib.flat_update_batch.restype = _I
        lib.send_view.argtypes = [_P, _P, _P, _F, _P, _F, _P, _LL, _I, _P]
        lib.send_view.restype = _I
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

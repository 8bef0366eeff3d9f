"""Build, bind and count the port's CUDA kernels: one loader for all.

Each kernel package declares one ``Library``: a CUDA source under its
``csrc/``, the kernel names it launches, and a ``bind`` function that
sets the ctypes signatures.  ``Library.load()`` compiles the source with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
at first use, under ``build/repro_torch/`` at the repository root
(listed in .gitignore), and loads it with ``ctypes``.  The library name
carries a hash of the source and the flags, so an edited source builds
anew and an unchanged one loads at once.  A failed build raises: there
is no fallback.

One lock covers every build and load, so two threads that reach a
kernel for the first time at once build it once (the cluster's master
also loads its libraries in ``Master.warm`` before workers start).
``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them together.  A process that must not build (a child of the
cluster's process backend, whose parent built every library before it
started it) sets ``NO_BUILD``: a library not built yet then raises
instead of starting ``nvcc``.

``launch(fn, index, *args)`` is the wrappers' lean launch path: it
calls a library's C entry point with the raw handle of the current CUDA
stream of device ``index`` appended, and enters ``torch.cuda.device``
only when that device is not the current one.

``LAUNCHES`` counts kernel launches per kernel name.  The wrappers call
``count(name)`` where they launch a kernel and nowhere else, so a run
can show that its path went through the kernels (``reset_launches``
before it, ``launches`` after).  A wrapper that applies k messages
through one kernel's launches per message counts k (``count(name, k)``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# no --use_fast_math: the kernels need IEEE sqrtf and division;
# -fmad=false keeps a*b+c rounded twice, as the plain versions round it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {}
LIBRARIES: list["Library"] = []
NO_BUILD = False                  # load only: a missing library raises
_LOCK = threading.Lock()          # builds and loads
_COUNT_LOCK = threading.Lock()    # launch counters


def count(name: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += n


def reset_launches(names=None) -> None:
    with _COUNT_LOCK:
        for name in (LAUNCHES if names is None else names):
            LAUNCHES[name] = 0


def launches(names=None) -> dict:
    with _COUNT_LOCK:
        return {n: LAUNCHES[n] for n in (LAUNCHES if names is None
                                         else names)}


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def launch(fn, index: int, *args) -> int:
    """``fn(*args, stream)`` on device ``index``: ``stream`` is the raw
    handle of that device's current stream (PyTorch's, so the launch
    orders with the caller's work and CUDA graph capture sees it).

    The stream comes from the private ``torch._C._cuda_getCurrentRawStream``
    (0.11-0.17 us a call against 3.5-5.9 us for the public
    ``torch.cuda.current_stream(dev).cuda_stream``, which builds a
    ``Stream`` object; ``scripts/torch_host_cost.py``); this is the only
    place that calls it.  The device context (1.8-2.1 us) is entered only
    when ``index`` is not the current device."""
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels cannot be built")


class Library:
    """One CUDA source built into one shared library."""

    def __init__(self, name: str, source: Path,
                 bind: Callable[[ctypes.CDLL], None], kernels):
        self.name = name
        self.source = Path(source)
        self.bind = bind
        self.kernels = tuple(kernels)
        self.info: dict = {}        # nvcc seconds and ptxas report
        self._lib = None
        for k in self.kernels:
            LAUNCHES.setdefault(k, 0)
        LIBRARIES.append(self)

    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    # -- build (callers hold _LOCK) --------------------------------------
    def _start(self):
        out = self.path()
        if out.exists():
            self.info.setdefault("seconds", 0.0)
            return None
        if NO_BUILD:
            raise RuntimeError(f"{out.name} is not built and this process "
                               f"may not build it (NO_BUILD)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return proc, cmd, tmp, out, time.perf_counter()

    def _finish(self, started) -> None:
        proc, cmd, tmp, out, t0 = started
        stdout, stderr = proc.communicate()
        self.info["seconds"] = time.perf_counter() - t0
        self.info["ptxas"] = stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{stdout}{stderr}")
        os.replace(tmp, out)

    def _build_locked(self) -> Path:
        started = self._start()
        if started is not None:
            self._finish(started)
        return self.path()

    # -- public ------------------------------------------------------------
    def build(self) -> Path:
        """Compile unless this source's library exists; return its path."""
        with _LOCK:
            return self._build_locked()

    def load(self) -> ctypes.CDLL:
        """The bound library (built at first use)."""
        lib = self._lib
        if lib is not None:
            return lib
        with _LOCK:
            if self._lib is None:
                lib = ctypes.CDLL(str(self._build_locked()))
                self.bind(lib)
                self._lib = lib
            return self._lib


def build_all(libraries=None) -> None:
    """Build every library not built yet, one ``nvcc`` per source, all
    started together; raises on the first failure after all ended."""
    libs = LIBRARIES if libraries is None else libraries
    with _LOCK:
        started = [(lib, lib._start()) for lib in libs]
        errors = []
        for lib, s in started:
            if s is None:
                continue
            try:
                lib._finish(s)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]

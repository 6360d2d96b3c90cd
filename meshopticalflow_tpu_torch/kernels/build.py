"""nvcc builds of the port's CUDA sources into ctypes-loaded libraries.

Each library is one ``csrc/*.cu`` file with a plain C interface, compiled
for ``sm_90a`` at first use into ``_build/`` beside this package's sources
and keyed by a hash of the source and its nvcc flags, so an edited source
or flag builds anew and an unchanged one is loaded as it is. A library
takes ``NVCC_FLAGS`` unless it names its own (the march library adds
``-fmad=false``). ``build_all`` starts one nvcc per library
at once and waits for all of them (the first call on a fresh machine).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


class CudaLibrary:
    """One nvcc-built shared library: its build, its load, its C signatures.

    ``bind(lib)`` sets ``argtypes`` / ``restype`` of the loaded entry points
    and returns the handle that ``load()`` hands out.
    """

    def __init__(self, stem: str, source: str, bind: Callable[[ctypes.CDLL], Any],
                 flags: Tuple[str, ...] = NVCC_FLAGS):
        self.stem = stem
        self.source = CSRC / source
        self.flags = tuple(flags)
        self._bind = bind
        self._lib: Any = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        key = self.source.read_bytes() + "\0".join(self.flags).encode()
        digest = hashlib.sha256(key).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.stem}_{digest}.so"

    def command(self, out: str, compiler: Optional[str] = None) -> list:
        """The nvcc command line that builds this library into ``out``."""
        return [compiler or nvcc(), *self.flags, "-o", out, str(self.source)]

    def start(self) -> Optional[Tuple[subprocess.Popen, str, Path, list]]:
        """Start nvcc unless the library is built; returns the pending build."""
        out = self.path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = self.command(tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        return proc, tmp, out, cmd

    @staticmethod
    def finish(pending) -> None:
        proc, tmp, out, cmd = pending
        try:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
            os.replace(tmp, out)   # atomic: concurrent builders race harmlessly
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def build(self) -> Path:
        pending = self.start()
        if pending is not None:
            self.finish(pending)
        return self.path()

    def load(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._bind(ctypes.CDLL(str(self.build())))
        return self._lib


def build_all(libraries) -> Dict[str, Path]:
    """Build every library with one nvcc process each, all started at once."""
    pending = [(lib, lib.start()) for lib in libraries]
    try:
        for _, p in pending:
            if p is not None:
                CudaLibrary.finish(p)
    finally:
        for _, p in pending:
            if p is not None and p[0].poll() is None:
                p[0].kill()
                p[0].wait()
            if p is not None and os.path.exists(p[1]):
                os.unlink(p[1])
    return {lib.stem: lib.path() for lib in libraries}


def stream_of(device) -> int:
    """The raw handle of the current CUDA stream of ``device``."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")

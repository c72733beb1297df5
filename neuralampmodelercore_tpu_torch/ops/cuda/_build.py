"""Build a ``csrc/*.cu`` kernel source into a shared library and load it.

Every kernel of the port is CUDA C++ with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/`` (gitignored) at first use
and bound with ctypes. A build is keyed by the hash of its source, of every
``csrc/*.cuh`` header and of the flags, so an edited source never loads a
stale library. Nothing is built or loaded when a module is imported.

    LIB = Library("lstm.cu", bind)     # bind(lib) declares argtypes/restype
    lib = LIB.load()                   # nvcc on first use, then ctypes.CDLL
    LIB.build_log                      # nvcc's output: ptxas registers, spills
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Optional

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


class Library:
    """One kernel source and its shared library."""

    def __init__(self, source_name: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source_name
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        #: nvcc's output of the build (``-Xptxas -v``: registers, shared memory, spills).
        self.build_log = ""

    def path(self) -> Path:
        """Where the build of the current sources goes, keyed by their hash."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}_{h.hexdigest()[:16]}.so"

    def compile(self) -> Path:
        """Run nvcc on the source unless this source's build exists already."""
        so = self.path()
        log = so.with_suffix(".log")
        if so.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {self.source.name}:\n{self.build_log}")
        log.write_text(self.build_log)
        os.replace(tmp, so)
        return so

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.compile()))
            self._bind(lib)
            lib.nam_cuda_error_string.argtypes = [ctypes.c_int]
            lib.nam_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise on a launch's cudaError_t (after ``load``)."""
        if err != 0:
            raise RuntimeError(f"{what} launch failed: {self._lib.nam_cuda_error_string(err).decode()} ({err})")

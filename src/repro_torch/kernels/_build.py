"""Build a kernel's CUDA source with ``nvcc`` and bind it with ``ctypes``.

Every CUDA kernel of the port is one ``csrc/*.cu`` file with a plain C entry
point (the ``hopper-kernels`` route (b): seconds to build, where a source
that includes PyTorch's headers takes minutes).  :class:`CudaLibrary`
compiles such a file at first use into ``<checkout>/build/repro_torch/``
(``build/`` is git-ignored), named by a hash of the source and the flags,
and loads it once per process.  Nothing here runs at import time: this
module imports on machines without ``nvcc`` or a card.
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
from typing import Callable

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)


def build_dir() -> Path:
    """``<checkout>/build/repro_torch`` (``build/`` is git-ignored)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


class CudaLibrary:
    """One CUDA source built into one shared library.

    ``bind(lib)`` sets the ``argtypes``/``restype`` of the library's entry
    points; it runs once, when the library is first loaded."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the build of the current source and flags lives."""
        key = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return build_dir() / f"{self.source.stem}_{key}.so"

    def build(self, verbose: bool = False) -> Path:
        """Compile the source unless this exact build exists.  ``verbose``
        adds ``-Xptxas -v`` and prints the compiler's report."""
        out = self.path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr)
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        """The bound library, building it at first use."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib

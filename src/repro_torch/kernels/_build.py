"""Build and load the port's hand-written CUDA kernels (nvcc + ctypes).

Each kernel source under ``kernels/*/csrc/`` exposes a plain C interface
and is compiled on first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at the root of the checkout, one shared library per
source, named by a hash of the source and the flags (a changed source
builds anew, an unchanged one loads from the cache).  Nothing here runs
at import time: the CPU tests import every module without a compiler.

Every C entry returns ``cudaGetLastError()`` after its launches; the
wrapper raises on any non-zero code, so a refused launch never passes
silently.  ``--use_fast_math`` / ``-ftz`` are deliberately absent:
flushing subnormals would change comparisons against the plain versions.
``-Xptxas -v`` makes ptxas report each kernel's registers, shared memory
and spills; a fresh build keeps that report in ``CudaLibrary.ptxas_log``.
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

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels build only where the CUDA toolkit "
                           "is installed")
    return str(candidate)


class CudaLibrary:
    """One kernel source: its build, its loaded library and its launch
    count.  ``functions`` maps each C entry to its ctypes argument types
    (every entry returns an int CUDA error code); ``error_fn`` names the
    entry that turns a code into ``cudaGetErrorString`` text.

    ``launches`` is incremented by the Python wrapper each time it
    launches the kernel, and nowhere else.
    """

    def __init__(self, source: Path, functions: dict[str, list],
                 error_fn: str):
        self.source = Path(source)
        self.functions = functions
        self.error_fn = error_fn
        self.launches = 0
        self.ptxas_log = None           # set by a build in this process
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.source.stem}-{digest[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` for this source unless its library is cached.
        Returns a handle for :meth:`finish_build`, or None when cached."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return proc, tmp, out

    def finish_build(self, handle) -> None:
        if handle is None:
            return
        proc, tmp, out = handle
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source} "
                               f"(exit {proc.returncode}):\n{err}")
        self.ptxas_log = err
        os.replace(tmp, out)

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.library_path()))
                for name, argtypes in self.functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                err = getattr(lib, self.error_fn)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def call(self, name: str, *args) -> None:
        """Run one C entry and raise if it reports a CUDA error."""
        lib = self.lib()
        rc = getattr(lib, name)(*args)
        if rc != 0:
            msg = getattr(lib, self.error_fn)(rc).decode()
            raise RuntimeError(f"{self.source.name}:{name} failed with CUDA "
                               f"error {rc}: {msg}")


def build_all(libraries) -> float:
    """Build every library that is not cached, all ``nvcc`` processes at
    once (one per distinct source and flags), then load them.  Returns the
    wall seconds taken."""
    t0 = time.perf_counter()
    handles, started = [], set()
    for lib in libraries:
        path = lib.library_path()
        handles.append((lib, None if path in started else lib.start_build()))
        started.add(path)
    errors = []
    for lib, handle in handles:          # wait for every process first
        try:
            lib.finish_build(handle)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.lib()
    return time.perf_counter() - t0

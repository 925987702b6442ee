"""Build-at-first-use with nvcc, shared by the port's hand-written CUDA
kernels.

Each kernel source under ``csrc/`` has a plain C interface and no
PyTorch header, so nvcc compiles it in seconds.  A ``KernelLibrary``
compiles its source into ``build/kernels/`` (listed in .gitignore)
under a name that carries a hash of the source, of every device-code
header beside it (``csrc/*.cuh``) and of the flags, loads it
with ctypes and declares the argument types of its entry points
(``c_void_p`` for every pointer and for the stream: an undeclared
pointer would be cut to 32 bits).  Nothing is built when a module is
imported, and a failed build raises: no caller carries on without its
kernel.

The kernels are built with ``--fmad=false`` and without
``--use_fast_math``: the plain PyTorch versions they are held against
round every product and sum on its own, and ``1.0f / x`` and ``sqrtf``
stay IEEE.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_ROOT, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_ROOT), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 600


def headers() -> list:
    """The device-code headers beside the kernel sources (``csrc/*.cuh``),
    which a source may include: a library's name hashes all of them, so
    an edit to one never loads a library built before it."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME
    (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


class KernelLibrary:
    """One ``csrc/<name>.cu`` compiled to a shared library, built and
    loaded once per process.

    ``functions`` maps each exported C function to its ctypes argument
    types; every function returns the launch's ``cudaGetLastError()``
    as an int.  A benchmark may build a variant of a kernel: ``defines``
    are extra ``-D`` flags."""

    def __init__(self, name: str, functions: dict, defines=()):
        self.name = name
        self.source = os.path.join(CSRC_DIR, f"{name}.cu")
        self.functions = functions
        self.flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
        self.handle = None
        self.path = None
        self.build_seconds = None
        self.compiler_log = ""  # ptxas -v lines of the library's build
        self._proc = None
        self._tmp = None
        self._t0 = None

    def _target(self) -> str:
        digest = hashlib.sha1()
        for path in (self.source, *headers()):
            with open(path, "rb") as f:
                digest.update(f.read())
        digest.update(" ".join(self.flags).encode())
        tag = digest.hexdigest()[:12]
        return os.path.join(BUILD_DIR, f"libtrt_{self.name}_{tag}.so")

    def start_build(self) -> None:
        """Start nvcc on the source without waiting for it, so that
        several libraries compile side by side; ``load`` waits.  Does
        nothing when the library is loaded, building or already built."""
        if self.handle is not None or self._proc is not None:
            return
        self._t0 = time.perf_counter()
        self.path = self._target()
        if os.path.exists(self.path):
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        self._tmp = f"{self.path}.{os.getpid()}.tmp"
        self._proc = subprocess.Popen(
            [nvcc(), *self.flags, "-Xptxas", "-v", "-o", self._tmp,
             self.source],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def load(self) -> ctypes.CDLL:
        """The loaded library; compiles it first if need be.  Raises
        RuntimeError with the compiler's output when the build fails."""
        if self.handle is not None:
            return self.handle
        self.start_build()
        if self._proc is not None:
            proc, self._proc = self._proc, None
            try:
                out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise RuntimeError(f"nvcc timed out on {self.source}")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {self.source}:\n"
                    f"{out}\n{err}")
            with open(f"{self.path}.log", "w") as f:
                f.write(err)
            os.replace(self._tmp, self.path)
        if os.path.exists(f"{self.path}.log"):
            with open(f"{self.path}.log") as f:
                self.compiler_log = f.read()
        lib = ctypes.CDLL(self.path)
        for fname, argtypes in self.functions.items():
            fn = getattr(lib, fname)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
        self.handle = lib
        self.build_seconds = time.perf_counter() - self._t0
        return lib


def build_all(libraries) -> None:
    """Compile ``libraries`` side by side (one nvcc each, all started
    together) and load them."""
    for lib in libraries:
        lib.start_build()
    for lib in libraries:
        lib.load()

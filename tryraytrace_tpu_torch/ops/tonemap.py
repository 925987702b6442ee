"""Accumulator tonemap: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel tryraytrace_tpu/ops/pallas_tonemap.py
(``_tonemap_kernel``): average the radiance sum by the sample count,
clamp to [0, 1], gamma 1/2.2, ``* 255 + 0.5``, truncate to uint8 (the
reference's toInt, common.h:126-128).  It runs on the card so that
only the 3 B/pixel image crosses to the host.  It is bound by bytes
(12 B read and 3 B written per pixel), so it is one coalesced
elementwise pass (csrc/tonemap.cu).

``tonemap`` runs the plain version for a CPU tensor and the kernel for
a CUDA tensor; there is no fallback between the two.  The kernel is
compiled with nvcc at first use into ``build/kernels/`` (listed in
.gitignore) and bound with ctypes.

The sample-count reciprocal is one float32 division on the host,
``float32(1) / float32(max(spp, 1))``, as the JAX device path divides;
for integer counts it equals the host path's float64 quotient rounded
to float32 (tests/test_torch_tonemap.py checks both).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "csrc", "tonemap.cu")
BUILD_DIR = os.path.join(os.path.dirname(_ROOT), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

GAMMA_EXP = float(np.float32(1.0 / 2.2))


def inv_spp(spp: int) -> float:
    """float32(1) / float32(max(spp, 1)), as a Python float."""
    return float(np.float32(1.0) / np.float32(max(int(spp), 1)))


def tonemap_plain(accum: torch.Tensor, spp: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel: uint8 [N, 3] on
    ``accum``'s device."""
    x = torch.clamp(accum * inv_spp(spp), 0.0, 1.0)
    return (torch.pow(x, GAMMA_EXP) * 255.0 + 0.5).to(torch.int32).to(
        torch.uint8)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


class _Library:
    """The compiled kernel library, built once per process."""

    handle = None
    path = None
    build_seconds = None

    @classmethod
    def load(cls):
        if cls.handle is not None:
            return cls.handle
        with open(SOURCE, "rb") as f:
            tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                               ).hexdigest()[:12]
        path = os.path.join(BUILD_DIR, f"libtrt_tonemap_{tag}.so")
        t0 = time.perf_counter()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        fn = lib.trt_tonemap_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        cls.handle, cls.path = lib, path
        cls.build_seconds = time.perf_counter() - t0
        return lib


def build_library() -> str:
    """Compile (if needed) and load the kernel library; returns its
    path.  ``_Library.build_seconds`` holds the time it took."""
    _Library.load()
    return _Library.path


def tonemap_cuda(accum: torch.Tensor, spp: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``accum`` ([N, 3] float32, contiguous,
    on a CUDA device) on the current stream -> uint8 [N, 3]."""
    if accum.device.type != "cuda":
        raise ValueError(f"tonemap_cuda needs a CUDA tensor, got "
                         f"{accum.device}")
    if accum.dtype != torch.float32:
        raise ValueError(f"accum must be float32, got {accum.dtype}")
    if accum.dim() != 2 or accum.shape[1] != 3:
        raise ValueError(f"accum must be [N, 3], got {tuple(accum.shape)}")
    if not accum.is_contiguous():
        raise ValueError("accum must be contiguous")
    lib = _Library.load()
    out = torch.empty(accum.shape, dtype=torch.uint8, device=accum.device)
    with torch.cuda.device(accum.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trt_tonemap_launch(accum.data_ptr(), out.data_ptr(),
                                     accum.numel(), inv_spp(spp), GAMMA_EXP,
                                     stream)
    if err != 0:
        raise RuntimeError(f"tonemap kernel launch failed: CUDA error {err}")
    tonemap_cuda.launches += 1
    return out


tonemap_cuda.launches = 0


def tonemap(accum: torch.Tensor, spp: int) -> torch.Tensor:
    """uint8 [N, 3] tonemap of ``accum`` on its own device: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if accum.device.type == "cpu":
        return tonemap_plain(accum, spp)
    return tonemap_cuda(accum, spp)

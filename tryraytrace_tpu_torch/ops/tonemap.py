"""Accumulator tonemap: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel tryraytrace_tpu/ops/pallas_tonemap.py
(``_tonemap_kernel``): average the radiance sum by the sample count,
clamp to [0, 1], gamma 1/2.2, ``* 255 + 0.5``, truncate to uint8 (the
reference's toInt, common.h:126-128).  It runs on the card so that
only the 3 B/pixel image crosses to the host.  It reads 12 B and
writes 3 B per pixel in 16-byte loads and 4-byte stores, in a
grid-stride loop over as many blocks as the card holds
(csrc/tonemap.cu); its IEEE ``powf`` per byte takes longer than the
bytes on an H100.

``tonemap`` runs the plain version for a CPU tensor and the kernel for
a CUDA tensor; there is no fallback between the two.  The kernel is
compiled with nvcc at first use and bound with ctypes (ops/_build.py).

The sample-count reciprocal is one float32 division on the host,
``float32(1) / float32(max(spp, 1))``, as the JAX device path divides;
for integer counts it equals the host path's float64 quotient rounded
to float32 (tests/test_torch_tonemap.py checks both).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tryraytrace_tpu_torch.ops._build import KernelLibrary

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


LIBRARY = KernelLibrary("tonemap", {
    "trt_tonemap_grid": (ctypes.c_void_p,),
    "trt_tonemap_launch": (ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_float,
                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p)})
_grids = {}  # the grid that fills a device, by (library, device)


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
    library = LIBRARY
    lib = library.load()
    out = torch.empty(accum.shape, dtype=torch.uint8, device=accum.device)
    key = (library.path, accum.device.index)
    with torch.cuda.device(accum.device):
        if key not in _grids:
            grid = ctypes.c_int()
            err = lib.trt_tonemap_grid(ctypes.byref(grid))
            if err != 0:
                raise RuntimeError(f"tonemap kernel cannot be planned: "
                                   f"CUDA error {err}")
            _grids[key] = grid.value
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trt_tonemap_launch(accum.data_ptr(), out.data_ptr(),
                                     accum.numel(), inv_spp(spp), GAMMA_EXP,
                                     _grids[key], stream)
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

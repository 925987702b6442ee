"""The bounce engine's walks over the threaded table: the hand-written
CUDA kernel (csrc/threaded_walk.cu) and its dispatch.

On the TPU the bounce engine's traversals are XLA-fused ``jnp``
while-loops, ``closest_hit_packed`` and ``any_hit_packed``
(tryraytrace_tpu/ops/traverse.py), one threaded row per lane per loop
iteration.  Their plain PyTorch versions keep those names in
ops/traverse.py; ``threaded_walk_cuda`` runs every lane's walk to its
end in one launch, one thread per ray, and gives the same result field
for field.  ``closest_hit`` and ``any_hit`` take the plain version for
CPU tensors and the kernel for CUDA tensors; there is no fallback
between the two.  Each returns the rows fetched, summed over the lanes,
as an int64 tensor.
"""

from __future__ import annotations

import ctypes

import torch

from tryraytrace_tpu_torch.accel.bvh import LEAF_FORMATS, traversal_row_width
from tryraytrace_tpu_torch.ops._build import KernelLibrary
from tryraytrace_tpu_torch.ops.traverse import (MISS_T, any_hit_packed,
                                                closest_hit_packed)

_COMMON = (
    # table, sentinel, row width, leaf size, leaf format, lanes
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong,
    # o, d
    ctypes.c_void_p, ctypes.c_void_p)
LIBRARY = KernelLibrary("threaded_walk", {
    # ..., active, t out, id out, rows counter, stream
    "trt_threaded_closest_launch": (*_COMMON, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p),
    # ..., max_dist, active, occluded out, rows counter, stream
    "trt_threaded_any_launch": (*_COMMON, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p)})


def _check(name, t, dtype, shape, dev):
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {dev}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def threaded_walk_cuda(table, k: int, r_o, r_d, active, max_dist=None, *,
                       fmt: str):
    """Launch the threaded walk on the current stream: the closest hit
    when ``max_dist`` is None -> (t [N] f32, prim id [N] int64; 1e20 / -1
    on a miss, rows fetched), else the any hit inside ``max_dist`` ->
    (occluded [N] bool, rows fetched).

    ``table`` is the threaded table (accel/bvh.py
    ``pack_traversal_table``): [M, width] float32 on a CUDA device,
    contiguous, with ``k`` slots of format ``fmt`` per leaf.  ``r_o``,
    ``r_d`` [N, 3] float32, ``active`` [N] bool and ``max_dist`` [N]
    float32 lie on the same device, contiguous.  Lanes not ``active``
    report a miss (not occluded)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"threaded_walk_cuda needs CUDA tensors, got {dev}")
    if (table.dim() != 2 or table.dtype != torch.float32
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous [rows, width] float32 "
                         "tensor")
    if fmt not in LEAF_FORMATS:
        raise ValueError(f"unknown leaf format {fmt!r} (the kernel is "
                         f"built for {sorted(LEAF_FORMATS)})")
    sentinel, width = table.shape
    if k < 1 or traversal_row_width(k, fmt) > width:
        raise ValueError(f"rows of {width} floats cannot hold threaded rows "
                         f"with {k} {fmt!r} triangles per leaf")
    if sentinel >= 2**31:
        raise ValueError(f"{sentinel} rows: node ids must fit in 31 bits")
    n = r_o.shape[0]
    _check("r_o", r_o, torch.float32, (n, 3), dev)
    _check("r_d", r_d, torch.float32, (n, 3), dev)
    _check("active", active, torch.bool, (n,), dev)
    shadow = max_dist is not None
    if shadow:
        _check("max_dist", max_dist, torch.float32, (n,), dev)
    rows = torch.zeros((), dtype=torch.int64, device=dev)
    if shadow:
        occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    else:
        t = torch.full((n,), MISS_T, device=dev)
        hit_id = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if n > 0 and sentinel > 0:
        lib = LIBRARY.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            common = (table.data_ptr(), sentinel, width, k,
                      LEAF_FORMATS[fmt], n, r_o.data_ptr(), r_d.data_ptr())
            if shadow:
                err = lib.trt_threaded_any_launch(
                    *common, max_dist.data_ptr(), active.data_ptr(),
                    occ.data_ptr(), rows.data_ptr(), stream)
            else:
                err = lib.trt_threaded_closest_launch(
                    *common, active.data_ptr(), t.data_ptr(),
                    hit_id.data_ptr(), rows.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"threaded_walk kernel launch failed: CUDA "
                               f"error {err}")
        threaded_walk_cuda.launches += 1
    return (occ, rows) if shadow else (t, hit_id, rows)


threaded_walk_cuda.launches = 0


def closest_hit(table, k: int, r_o, r_d, active, *, fmt: str):
    """Closest hit over the threaded table on its own device -> (t, prim
    id, rows fetched): the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if table.device.type == "cpu":
        return closest_hit_packed(table, k, r_o, r_d, active, fmt=fmt)
    return threaded_walk_cuda(table, k, r_o, r_d, active, fmt=fmt)


def any_hit(table, k: int, r_o, r_d, max_dist, active, *, fmt: str):
    """Any hit inside ``max_dist`` over the threaded table on its own
    device -> (occluded, rows fetched): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if table.device.type == "cpu":
        return any_hit_packed(table, k, r_o, r_d, max_dist, active, fmt=fmt)
    return threaded_walk_cuda(table, k, r_o, r_d, active, max_dist, fmt=fmt)

"""The bounce engine's walks over the threaded table: the hand-written
CUDA kernel (csrc/threaded_walk.cu) and its dispatch.

On the TPU the bounce engine's traversals are XLA-fused ``jnp``
while-loops, ``closest_hit_packed`` and ``any_hit_packed``
(tryraytrace_tpu/ops/traverse.py), one threaded row per lane per loop
iteration.  Their plain PyTorch versions keep those names in
ops/traverse.py; ``threaded_walk_cuda`` runs every lane's walk to its
end in one launch, one thread a ray, and gives the same result field
for field.

Both walk the walk-order copy of the threaded rows (``walk_table``,
accel/bvh.py ``threaded_walk_order_table``): the same rows breadth-first
with 16-byte rows, on which the plain versions reach the same rows in
the same order as on ``DeviceScene.node_table``.  ``closest_hit`` and
``any_hit`` take the plain version for CPU tensors and the kernel for
CUDA tensors; there is no fallback between the two.  Each returns the
rows fetched, summed over the lanes, as an int64 tensor.
"""

from __future__ import annotations

import ctypes

import torch

from tryraytrace_tpu_torch.accel.bvh import (LEAF_FORMATS,
                                             threaded_walk_order_table,
                                             traversal_row_width)
from tryraytrace_tpu_torch.ops._build import KernelLibrary
from tryraytrace_tpu_torch.ops.traverse import (any_hit_packed,
                                                closest_hit_packed)


def walk_table(node_table: torch.Tensor, leaf_size: int,
               leaf_fmt: str) -> torch.Tensor:
    """The walk-order copy of a scene's threaded table
    (``DeviceScene.node_table``) on the table's device: what both walks
    read."""
    rows, _ = threaded_walk_order_table(node_table.cpu().numpy(), leaf_size,
                                        leaf_fmt)
    return torch.as_tensor(rows, device=node_table.device)


LIBRARY = KernelLibrary("threaded_walk", {
    "trt_threaded_walk_launch": (
        # table, sentinel, row width, leaf size, leaf format, lanes
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong,
        # o, d, active, max_dist (any hit, else null)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        # t, id (closest hit), occluded (any hit), rows counter, stream
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
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

    ``table`` is the walk-order copy of the threaded rows
    (``walk_table``): [M, width] float32 on a CUDA device, contiguous,
    16-byte aligned, ``width`` a multiple of 4, with ``k`` slots of
    format ``fmt`` per leaf.  ``r_o``, ``r_d`` [N, 3] float32, ``active``
    [N] bool and ``max_dist`` [N] float32 lie on the same device,
    contiguous.  Lanes not ``active`` report a miss (not occluded).  The
    kernel writes every lane's outputs, so they are allocated
    unfilled."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"threaded_walk_cuda needs CUDA tensors, got {dev}")
    if (table.dim() != 2 or table.dtype != torch.float32
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous [rows, width] float32 "
                         "tensor")
    sentinel, width = table.shape
    if width % 4 or table.data_ptr() % 16:
        raise ValueError(f"the kernel reads 16-byte rows: a row of {width} "
                         "floats, or a table not 16-byte aligned, is not "
                         "one (threaded_walk_order_table pads the rows)")
    if fmt not in LEAF_FORMATS:
        raise ValueError(f"unknown leaf format {fmt!r} (the kernel is "
                         f"built for {sorted(LEAF_FORMATS)})")
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
        occ = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        t = torch.empty((n,), device=dev)
        hit_id = torch.empty((n,), dtype=torch.int64, device=dev)
    if n > 0:
        lib = LIBRARY.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.trt_threaded_walk_launch(
                table.data_ptr(), sentinel, width, k, LEAF_FORMATS[fmt], n,
                r_o.data_ptr(), r_d.data_ptr(), active.data_ptr(),
                max_dist.data_ptr() if shadow else None,
                None if shadow else t.data_ptr(),
                None if shadow else hit_id.data_ptr(),
                occ.data_ptr() if shadow else None, rows.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"threaded_walk kernel launch failed: CUDA "
                               f"error {err}")
        threaded_walk_cuda.launches += 1
    return (occ, rows) if shadow else (t, hit_id, rows)


threaded_walk_cuda.launches = 0


def closest_hit(table, k: int, r_o, r_d, active, *, fmt: str):
    """Closest hit over the threaded rows ``table`` (``walk_table``) on
    their own device -> (t, prim id, rows fetched): the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if table.device.type == "cpu":
        return closest_hit_packed(table, k, r_o, r_d, active, fmt=fmt)
    return threaded_walk_cuda(table, k, r_o, r_d, active, fmt=fmt)


def any_hit(table, k: int, r_o, r_d, max_dist, active, *, fmt: str):
    """Any hit inside ``max_dist`` over the threaded rows ``table`` on
    their own device -> (occluded, rows fetched): the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if table.device.type == "cpu":
        return any_hit_packed(table, k, r_o, r_d, max_dist, active, fmt=fmt)
    return threaded_walk_cuda(table, k, r_o, r_d, active, max_dist, fmt=fmt)

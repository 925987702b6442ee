"""Dependent row-fetch chain: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel of scripts/microbench_pallas_fetch.py
(``_fetch_kernel``, through ``onehot_fetch``).  ``steps`` times, every
lane fetches row ``idx`` of a ``[M, W]`` table, adds the row's column 0
(widened to float32) to its accumulator and advances
``idx = (idx + int(column 1) + 1) % M``, the cast truncating toward
zero.  The TPU kernel fetches with ``one_hot(idx) @ table``, which
selects one row exactly, so the function is a gather chain; a bfloat16
table accumulated in float32 returns its values exactly too.  It is
the small model of a BVH walk: one table row per lane per step, the
next row computed from the fetched one.

A GPU thread pays only for the columns it loads, so both versions also
read the whole row: ``rowsum`` is the float32 sum, in column order, of
the last row a lane fetched.  The comparison with the TPU kernel is on
``acc``.

The kernel (csrc/fetch_chain.cu) reads the table from device memory or,
with ``placement="shared"``, from a copy each block stages in shared
memory; the outputs are the same.  ``fetch_chain`` runs the plain
version for CPU tensors and the kernel for CUDA tensors; there is no
fallback between the two.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tryraytrace_tpu_torch.ops._build import KernelLibrary

# Dynamic shared memory one block may use on sm_90 (227 KB) and the gap
# the kernel leaves between staged rows (csrc/fetch_chain.cu kPadBytes).
SHARED_LIMIT_BYTES = 232448
SHARED_PAD_BYTES = 16

PLACEMENTS = ("global", "shared")

LIBRARY = KernelLibrary("fetch_chain", {
    "trt_fetch_chain_launch": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p)})


# (M, W, dtype, data-dependent): the five variants of the TPU script,
# whose tables are uniform in [0, 1) so that int(column 1) is 0 and the
# chain visits consecutive rows, and one whose column 1 holds integers,
# so that the next row really depends on the fetched one.
VARIANTS = (
    (1024, 128, torch.bfloat16, False),
    (1024, 256, torch.bfloat16, False),
    (512, 128, torch.bfloat16, False),
    (256, 128, torch.bfloat16, False),
    (1024, 128, torch.float32, False),
    (512, 128, torch.bfloat16, True),
)
LANES = 65536
STEPS = 64


def make_inputs(rs: np.random.RandomState, m: int, w: int, dtype,
                dependent: bool, lanes: int):
    """A seeded (table [m, w] ``dtype``, idx [lanes, 1] int32) pair on
    the CPU.  With ``dependent`` column 1 holds integers in [0, m) that
    bfloat16 represents exactly (multiples of m/256 once m passes 256)."""
    tab = rs.rand(m, w).astype(np.float32)
    if dependent:
        scale = max(1, m // 256)
        tab[:, 1] = rs.randint(0, m // scale, m) * scale
    idx = rs.randint(0, m, (lanes, 1)).astype(np.int32)
    return torch.from_numpy(tab).to(dtype), torch.from_numpy(idx)


def shared_bytes(table: torch.Tensor) -> int:
    """Shared memory the staged copy of ``table`` takes in each block."""
    m, w = table.shape
    return m * (w * table.element_size() + SHARED_PAD_BYTES)


def fits_shared(table: torch.Tensor) -> bool:
    return shared_bytes(table) <= SHARED_LIMIT_BYTES


def _check(table, idx, steps):
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table must be [M, W] float32 or bfloat16, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if table.shape[0] < 1 or table.shape[1] < 2:
        raise ValueError(f"table needs a row and two columns, got "
                         f"{tuple(table.shape)}")
    if idx.dim() != 2 or idx.shape[1] != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be [N, 1] int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def fetch_chain_plain(table: torch.Tensor, idx: torch.Tensor, steps: int):
    """The plain PyTorch version: ``table[idx]`` per step.  Returns
    (acc [N, 1], rowsum [N, 1]) float32 on the table's device."""
    _check(table, idx, steps)
    m, w = table.shape
    ix = idx[:, 0].to(torch.int64) % m
    acc = torch.zeros(ix.shape, dtype=torch.float32, device=table.device)
    rows = None
    for _ in range(steps):
        rows = table[ix]
        acc = acc + rows[:, 0].to(torch.float32)
        ix = (ix + rows[:, 1].to(torch.float32).to(torch.int64) + 1) % m
    rowsum = torch.zeros_like(acc)
    if rows is not None:
        last = rows.to(torch.float32)
        for c in range(w):
            rowsum = rowsum + last[:, c]
    return acc[:, None], rowsum[:, None]


def fetch_chain_cuda(table: torch.Tensor, idx: torch.Tensor, steps: int,
                     placement: str = "global"):
    """Launch the CUDA kernel on the current stream: ``table`` and ``idx``
    contiguous on one CUDA device, rows a multiple of 16 bytes, indices
    in [0, M) (the kernel reduces them mod M, as the plain version
    does).  Raises ValueError when ``placement="shared"`` and the table
    does not fit a block's shared memory.  Returns (acc, rowsum)."""
    _check(table, idx, steps)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"fetch_chain_cuda needs CUDA tensors on one "
                         f"device, got {table.device} and {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}")
    m, w = table.shape
    if (w * table.element_size()) % 16:
        raise ValueError(f"rows must be a multiple of 16 bytes, got "
                         f"{w * table.element_size()}")
    if placement == "shared" and not fits_shared(table):
        raise ValueError(
            f"a [{m}, {w}] {table.dtype} table takes {shared_bytes(table)} B "
            f"staged; a block has {SHARED_LIMIT_BYTES} B of shared memory")
    lib = LIBRARY.load()
    n = idx.shape[0]
    acc = torch.empty((n, 1), dtype=torch.float32, device=table.device)
    rowsum = torch.empty((n, 1), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trt_fetch_chain_launch(
            table.data_ptr(), idx.data_ptr(), acc.data_ptr(),
            rowsum.data_ptr(), n, m, w, table.element_size(), int(steps),
            int(placement == "shared"), stream)
    if err != 0:
        raise RuntimeError(f"fetch_chain kernel launch failed: CUDA error "
                           f"{err}")
    if n > 0:
        fetch_chain_cuda.launches += 1
    return acc, rowsum


fetch_chain_cuda.launches = 0


def fetch_chain(table: torch.Tensor, idx: torch.Tensor, steps: int,
                placement: str = "global"):
    """(acc, rowsum) of the chain on the table's own device: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if table.device.type == "cpu":
        return fetch_chain_plain(table, idx, steps)
    return fetch_chain_cuda(table, idx, steps, placement)

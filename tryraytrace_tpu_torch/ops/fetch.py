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
with ``placement="shared"``, stages the table's leading
``staged_rows(table)`` rows in each block's shared memory (all of them
where they fit) and reads the rest from device memory; the outputs are
the same.  Its modulo by M takes no division: ``mod_constants`` gives
the multiplier and shift it uses.  ``fetch_chain`` runs the plain
version for CPU tensors and the kernel for CUDA tensors; there is no
fallback between the two, nor from one placement to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tryraytrace_tpu_torch.ops._build import KernelLibrary

# Dynamic shared memory one block may use on sm_90 (227 KB), and the
# bytes the kernel keeps after the staged rows for the mbarrier its
# staging copy completes on (csrc/fetch_chain.cu kBarrierBytes).
SHARED_LIMIT_BYTES = 232448
STAGE_BARRIER_BYTES = 8
# The row sizes the kernel takes: a row is a whole number of 16-byte
# chunks, 1 to 32 of them, a power of two.
ROW_BYTES = (16, 32, 64, 128, 256, 512)

PLACEMENTS = ("global", "shared")

LIBRARY = KernelLibrary("fetch_chain", {
    "trt_fetch_chain_launch_staged": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p)})


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
# The latency variants: one warp of lanes on 16-byte rows whose column 1
# picks the next row, a table past any SM's L1 for device memory (2 MB)
# and one that shared memory holds (16 KB); a call's time over its steps
# is one dependent fetch step (scripts/microbench_torch_fetch.py).
LATENCY_VARIANTS = ((131072, 4, torch.float32, True),
                    (1024, 4, torch.float32, True))
LATENCY_LANES = 32


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


def staged_rows(table: torch.Tensor) -> int:
    """Rows of ``table`` that ``placement="shared"`` stages in a block's
    shared memory: the leading ones, all of them where they fit."""
    m, w = table.shape
    row = w * table.element_size()
    return min(m, (SHARED_LIMIT_BYTES - STAGE_BARRIER_BYTES) // row)


def mod_constants(m: int) -> tuple:
    """(magic, shift) of the kernel's floor modulo by ``m`` (1 <= m <
    2**31) without a division (Granlund and Montgomery, PLDI 1994, fig.
    4.1): shift = l = ceil(log2 m) and magic = floor(2**32 (2**l - m) / m)
    + 1, which is below 2**32."""
    if not 1 <= m < 2 ** 31:
        raise ValueError(f"the modulus must be in [1, 2**31), got {m}")
    shift = (m - 1).bit_length()
    magic = (2 ** 32 * (2 ** shift - m)) // m + 1
    return magic, shift


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
    contiguous on one CUDA device, the table 16-byte aligned with rows
    of ``ROW_BYTES``; the kernel reduces the indices mod M, as the plain
    version does.  ``placement="shared"`` stages ``staged_rows(table)``
    rows.  Raises ValueError on inputs the kernel does not take and
    RuntimeError when the launch fails.  Returns (acc, rowsum)."""
    _check(table, idx, steps)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"fetch_chain_cuda needs CUDA tensors on one "
                         f"device, got {table.device} and {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}")
    m, w = table.shape
    if w * table.element_size() not in ROW_BYTES:
        raise ValueError(f"rows must be one of {ROW_BYTES} bytes, got "
                         f"{w * table.element_size()}")
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    staged = staged_rows(table) if placement == "shared" else 0
    magic, shift = mod_constants(m)
    lib = LIBRARY.load()
    n = idx.shape[0]
    acc = torch.empty((n, 1), dtype=torch.float32, device=table.device)
    rowsum = torch.empty((n, 1), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trt_fetch_chain_launch_staged(
            table.data_ptr(), idx.data_ptr(), acc.data_ptr(),
            rowsum.data_ptr(), n, m, w, table.element_size(), int(steps),
            staged, magic, shift, stream)
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

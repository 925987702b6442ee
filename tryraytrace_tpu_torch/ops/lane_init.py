"""The persistent engine's lane set-up on the card: the hand-written CUDA
kernel that writes a wave's fresh lane state in one launch.

A wave starts with every lane on its pixel's sample 0: the camera ray of
(pixel, seed of sample 0) and the fixed values of the other fields.  On
the TPU this is part of the engine's jitted XLA program
(tryraytrace_tpu/engine/persistent.py:167 ``init_lane_ctx`` with
tryraytrace_tpu/engine/camera_rays.py:21 ``generate_rays``).  The
port's plain version is engine/persistent.py ``init_lane_ctx``, eager
PyTorch, which the engine runs on the CPU and on a card's plain round
loops; ``lane_init_cuda`` (csrc/lane_init.cu) is the card's, held to it
field for field, bit for bit (chip_smoke.py ``[lane_init]``).  On a card
``Wave`` allocates the state with ``new_lane_state`` and launches the
kernel once; a failed build or launch raises, and nothing falls back to
the plain version.  The kernel writes each field a tile of 256 lanes at
a time in 16-byte stores, so every field it writes must be 16-byte
aligned (``new_lane_state``'s are; the wrapper refuses one that is not).

The kernel takes the service kernel's packed parameters
(ops/service.py ``service_params``, ``state_pointers``), whose camera is
packed on the host from the caller's camera, so the set-up copies
nothing to the card and reads nothing back: it also writes the wave's
totals ([lanes, 0, 0, 0]) and row count (0).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tryraytrace_tpu_torch.ops import service
from tryraytrace_tpu_torch.ops._build import KernelLibrary

# The most lanes a wave may have (the kernels index lanes with int32
# lists, ops/wave.py).
MAX_LANES = 2 ** 31 - 1

LIBRARY = KernelLibrary("lane_init", {
    "trt_lane_init_layout": (ctypes.c_void_p,),
    "trt_lane_init_plan": (ctypes.c_void_p,),
    "trt_lane_init_launch": (
        # floats, ints, pointers (host arrays), reg_e, reg_s, registers,
        # first pixel (-1: read pix), lanes, rows, stream
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p)})

# The state fields the kernel writes (every one of ops/service.py FIELDS;
# pix only for a range of pixels) and the skip registers.
WRITTEN = tuple(name for name, _, _ in service.FIELDS) + ("reg_e", "reg_s")

_checked = set()  # libraries whose parameter layout matched the wrapper's


def new_lane_state(n: int, regs: int, textured: bool, device,
                   pixels=None) -> dict:
    """Lane state for ``n`` lanes on ``device``, allocated and not
    filled: the fields of engine/persistent.py ``init_lane_ctx``, in its
    order, with its dtypes and shapes (``reg_e`` and ``reg_s`` with
    ``regs`` columns when ``regs`` > 0, ``tstash`` when ``textured``).
    ``pix`` is ``pixels`` itself when given (an int64 [n] tensor the
    kernel reads), else allocated for the kernel to write."""
    dev = torch.device(device)
    empty = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=dev)
    i64, b = torch.int64, torch.bool
    st = {}
    if regs > 0:
        st["reg_e"] = empty(n, regs, dtype=i64)
        st["reg_s"] = empty(n, regs, dtype=i64)
    if textured:
        st["tstash"] = empty(n, 10)
    st.update(
        mode=empty(n, dtype=i64), cur=empty(n, dtype=i64), d_min=empty(n),
        hit_id=empty(n, dtype=i64), o=empty(n, 3), d=empty(n, 3),
        tp=empty(n, 3), rad=empty(n, 3), sample=empty(n, dtype=i64),
        seed=empty(n, dtype=i64),
        pix=empty(n, dtype=i64) if pixels is None else pixels,
        depth=empty(n, dtype=i64), prev_spec=empty(n, dtype=b),
        so=empty(n, 3), sd=empty(n, 3), smax=empty(n), pend=empty(n, 3),
        cont_after_shadow=empty(n, dtype=b), out=empty(n, 3))
    return st


def _check_layout(lib) -> None:
    layout = (ctypes.c_int * 4)()
    lib.trt_lane_init_layout(ctypes.addressof(layout))
    want = (len(service.FLOATS), len(service.INTS),
            3 + len(service.FIELDS) + 1, len(service.TOTALS))
    if tuple(layout) != want:
        raise RuntimeError(f"lane_init kernel takes {tuple(layout)} (floats, "
                           f"ints, pointers, totals), the wrapper packs "
                           f"{want}")


def launch_plan(library=LIBRARY) -> dict:
    """The kernel's launch plan on the current CUDA device: SMs,
    resident blocks an SM, the grid (their product: the most blocks a
    launch takes) and its static shared bytes a block (the camera rays'
    tiles)."""
    out = (ctypes.c_int * 4)()
    err = library.load().trt_lane_init_plan(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"lane_init kernel cannot be planned: CUDA error "
                           f"{err}")
    sms, per_sm, grid, shared = out
    return dict(sms=sms, blocks_per_sm=per_sm, grid=grid, shared_bytes=shared)


def lane_init_cuda(s, inline, params, totals, rows, first=None,
                   library=LIBRARY) -> dict:
    """Launch the lane set-up kernel on the current stream: every lane of
    ``s`` gets the fresh state of engine/persistent.py ``init_lane_ctx``
    for the wave whose constants ``params`` packs (ops/service.py
    ``service_params``: the raster, the camera, the seed schedule's base
    and sample offset), bit for bit.

    ``s`` is a lane state on the table's CUDA device, every field of
    ``ops/service.py FIELDS`` with its engine dtype and shape and
    contiguous (``new_lane_state`` allocates one), plus ``reg_e`` and
    ``reg_s`` (int64 [lanes, registers], contiguous) when the wave has
    skip registers; fewer than 2**31 lanes.  With ``first`` (an int),
    lane i renders pixel ``first + i`` and the kernel writes ``pix``;
    without, it reads the pixels from ``s["pix"]``.  ``totals``
    (``service.TOTALS``, int64 [4]) is set to [lanes, 0, 0, 0] and
    ``rows`` (int64, one element) to 0.  Every field the kernel writes
    (``WRITTEN``; ``pix`` only with ``first``) must start on 16 bytes.
    Refuses on the host, before any library is loaded, what the kernel
    cannot take.  ``library`` is the kernel's build (the port's, or a
    benchmark's build of the same C interface).  Waits for nothing on
    the device; returns ``s``."""
    n = int(s["mode"].shape[0])
    if n > MAX_LANES:
        raise ValueError(f"{n} lanes: the kernels take fewer than 2**31")
    if first is not None and int(first) < 0:
        raise ValueError(f"first pixel {first} < 0")
    for name in WRITTEN:
        t = s.get(name)
        if (t is not None and t.data_ptr() % 16 != 0
                and (name != "pix" or first is not None)):
            raise ValueError(f"state field {name!r} is not 16-byte aligned "
                             f"(data_ptr {t.data_ptr():#x}): the kernel "
                             f"writes it in 16-byte stores")
    dev = inline.table.device
    regs = 0
    if "reg_e" in s or "reg_s" in s:
        regs = int(s["reg_e"].shape[-1]) if "reg_e" in s else -1
        for name in ("reg_e", "reg_s"):
            t = s.get(name)
            if (t is None or t.device != dev or t.dtype != torch.int64
                    or tuple(t.shape) != (n, regs)
                    or not t.is_contiguous()):
                raise ValueError(f"skip registers {name!r} must be a "
                                 f"contiguous int64 tensor of shape "
                                 f"({n}, {regs}) on {dev}, as reg_e")
    if (rows.device != dev or rows.dtype != torch.int64 or rows.numel() != 1
            or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous one-element int64 "
                         f"tensor on {dev}")
    ptrs = service.state_pointers(s, inline, params, totals,
                                  "lane_init_cuda")
    lib = library.load()
    if library not in _checked:
        _check_layout(lib)
        _checked.add(library)
    host_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    floats = np.ascontiguousarray(params.floats, np.float32)
    ints = np.ascontiguousarray(params.ints, np.int64)
    reg_ptr = lambda name: s[name].data_ptr() if regs else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trt_lane_init_launch(
            floats.ctypes.data, ints.ctypes.data, ctypes.addressof(host_ptrs),
            reg_ptr("reg_e"), reg_ptr("reg_s"), regs,
            -1 if first is None else int(first), n, rows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"lane_init kernel launch failed: CUDA error "
                           f"{err}")
    lane_init_cuda.launches += 1
    return s


lane_init_cuda.launches = 0

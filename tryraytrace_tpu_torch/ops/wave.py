"""The persistent engine's wave loop on the card: the hand-written CUDA
kernel that runs every lane of a wave through its rounds in one launch,
and its plain PyTorch version.

A round of a lane is its walk to its end (ops/walk.py) and then its one
service (ops/service.py); a wave advances by rounds until every lane is
DONE or a budget of rounds is spent.  On the TPU that loop is a
``jax.lax.while_loop`` on the device with its stop condition there too
(tryraytrace_tpu/engine/persistent.py:623,635;
tryraytrace_tpu/engine/progressive.py:248).  ``wave_advance_cuda``
(csrc/wave_advance.cu) is that loop on the card: one cooperative launch
runs the rounds, each every listed lane's walk to its end, a grid-wide
barrier, every listed lane's service, a grid-wide barrier, up to
``max_rounds`` rounds or until no lane is live, with the walk's and the
service's device code as the two kernels of the round loop run them;
each round lists the lanes still live for the next.  Once a round
leaves few lanes live (the plan's ``tail_lanes``), the launch's warps
share them out and each warp runs its own rounds (its lanes' walks, then
their services) with no grid-wide barrier, to each lane's end or the
budget.  The host reads two numbers at the end.
``wave_advance_plain`` is the same contract as a loop of rounds over
``walk_plain`` and ``service_plain`` on every lane (no compaction); the
engine's CPU path keeps its own round loop (engine/persistent.py
``Wave.advance``), which compacts.

Both take the wave's lane state (on a card filled by the lane set-up
kernel, ops/lane_init.py ``lane_init_cuda``; on the CPU and in the plain
round loops by engine/persistent.py ``init_lane_ctx``, its plain
version) and update it in place, add the rows the walks fetch to
``rows`` and the path and shadow rays to ``totals`` (ops/service.py
``TOTALS``), leave the live count in the totals' slot of the last
round's parity (``rounds_before`` is the wave's rounds before the call)
with the other slot zeroed, as the round loop leaves them, and return
(rounds run, lanes not DONE after the call).  The rounds run are the most
that any lane ran: a lane that is live at the start of a round runs it,
so that is the round loop's count.

The lanes are independent (owner schedule), so the kernel's state,
sums, rays, rows and rounds are the round loop's bit for bit, field for
field (chip_smoke.py ``[wave]``), whatever order its lists hold and
whichever warp runs a lane's late rounds.  Signed zeros are the walk kernel's
(ops/walk.py): against the plain version, -0.0 == 0.0.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tryraytrace_tpu_torch.accel.bvh import LEAF_FORMATS
from tryraytrace_tpu_torch.ops import service, walk
from tryraytrace_tpu_torch.ops._build import KernelLibrary

# The launch's int64 counters (csrc/wave_advance.cu Ctl): the walk
# phases' lane claims and the rounds' live counts, taken in turn by the
# dense rounds, the lanes live at the start, the most rounds of a warp in
# the tail and the tail's lanes not DONE (all zero at launch and left
# zero), then the launch's rounds and live lanes.
CTL = ("claim0", "claim1", "live0", "live1", "start", "tail_rounds",
       "tail_live", "rounds", "live")
# The budget of a call without one: more rounds than any frame runs.
NO_BUDGET = 0x7FFFFFFF

LIBRARY = KernelLibrary("wave_advance", {
    "trt_wave_layout": (ctypes.c_void_p,),
    "trt_wave_advance_plan": walk.LIBRARY.functions["trt_quad_walk_plan"],
    "trt_wave_advance_launch": (
        # walk-order table, sentinel, row width, leaf size, regs, leaf
        # format, passes, staged rows, grid
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        # the service's floats, ints, pointers (host arrays)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        # lanes, max rounds, rounds before, counters, lists, rows, stream
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p)})

# The launch counters of each (device, stream, counter count): left zero
# by every launch but for the two results, so one tensor serves every
# launch in turn.
_ctl = {}
# The layout of each library whose arrays matched the wrapper's: its
# counters and its tail threshold (csrc/wave_advance.cu
# TRT_WAVE_TAIL_WARP_LANES).
_layouts = {}


def _check_layout(library, lib) -> tuple:
    """Refuse a library whose arrays differ from the wrapper's; returns
    (its counters, the last two the results; its tail threshold: a round
    that leaves at most that many live lanes a warp of the grid ends the
    grid-wide rounds, 0 never).  The port's library has ``CTL``'s
    counters; another build of the kernel (scripts/time_torch_wave.py
    times a parent's) may have others."""
    layout = (ctypes.c_int * 6)()
    lib.trt_wave_layout(ctypes.addressof(layout))
    want = (len(service.FLOATS), len(service.INTS),
            3 + len(service.FIELDS) + 1, len(service.TOTALS))
    n_ctl = layout[4]
    if (tuple(layout[:4]) != want or n_ctl < 2
            or (library is LIBRARY and n_ctl != len(CTL))):
        raise RuntimeError(f"wave_advance kernel takes {tuple(layout[:5])} "
                           f"(floats, ints, pointers, totals, counters), the "
                           f"wrapper packs {want} and {len(CTL)} counters")
    return n_ctl, layout[5]


def _budget(max_rounds) -> int:
    if max_rounds is None:
        return NO_BUDGET
    if not 1 <= int(max_rounds) <= NO_BUDGET:
        raise ValueError(f"max_rounds {max_rounds} is not in [1, "
                         f"{NO_BUDGET}] (or None)")
    return int(max_rounds)


def wave_advance_cuda(s, inline, params, totals, rows, max_rounds=None, *,
                      k: int, fmt: str, passes: int = 1,
                      rounds_before: int = 0, library=LIBRARY) -> tuple:
    """Launch the wave kernel on the current stream: every lane of state
    ``s`` runs rounds (its walk to its end over ``inline.walk``, then its
    service) until it is DONE or has run ``max_rounds`` of them (None:
    until DONE).

    ``s`` is the wave's lane state on the table's CUDA device, every
    field of ``ops/service.py FIELDS`` with its engine dtype and shape,
    contiguous, fewer than 2**31 lanes; it is written in place.  Its
    TRAVERSE and SHADOW lanes stand at row 0 with an empty
    skip-register file, as every fresh lane (``lane_init_cuda``,
    ``init_lane_ctx``) and every lane the kernel stops does (a lane
    stops only between rounds); this is not checked, since it would
    wait for the device.  ``inline`` is
    the engine's InlineTable (the walk-order rows and their top levels,
    ``k`` triangles of format ``fmt`` a leaf; the unified table the
    service reads), ``params`` the wave's ``service.service_params``,
    ``passes`` the skip registers' redirect sweeps.  ``totals``
    (``service.TOTALS``, int64 [4]) and ``rows`` (int64, one element) are
    the wave's and are added to; ``rounds_before`` is the wave's rounds
    before the call.  ``library`` is the kernel's build (the port
    launches ``LIBRARY``; a timing script another source or ``-D``
    build).  Refuses on the host, before any library is loaded, what the
    kernel cannot take.

    Returns (rounds run, lanes not DONE): the one read of the call
    (``read_counters``), which waits for the launch.  The launch's plan
    (staged rows, grid: the blocks the card holds at once, as a
    cooperative launch needs) is worked out once per table and device;
    it is left in ``wave_advance_cuda.plan`` with ``tail_lanes``, the
    live lanes at or below which a round ends the grid-wide rounds and
    the launch's warps run the lanes left on their own rounds (0:
    never).  Its scratch, two int32 lists of lanes, comes from PyTorch's
    allocator."""
    budget = _budget(max_rounds)
    if rounds_before < 0:
        raise ValueError(f"rounds_before {rounds_before} < 0")
    table, sentinel = inline.walk, inline.sentinel
    dev = table.device
    width, levels = walk.check_table(table, sentinel, k, fmt,
                                     inline.walk_levels, "wave_advance_cuda")
    regs = walk.state_regs(s)
    ptrs = service.state_pointers(s, inline, params, totals,
                                  "wave_advance_cuda")
    if (rows.device != dev or rows.dtype != torch.int64 or rows.numel() != 1
            or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous one-element int64 "
                         f"tensor on {dev}")
    w = s["mode"].shape[0]
    if w == 0:
        return 0, 0
    lib = library.load()
    if library not in _layouts:
        _layouts[library] = _check_layout(library, lib)
    n_ctl, tail_warp_lanes = _layouts[library]
    plan = dict(walk.launch_plan(library, lib.trt_wave_advance_plan, dev,
                                 regs, fmt, width, sentinel, levels))
    plan["grid"] = min(plan["grid"], -(-w // plan["threads"]))
    plan["tail_lanes"] = (plan["grid"] * plan["threads"] // 32
                          * tail_warp_lanes)
    host_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    floats = np.ascontiguousarray(params.floats, np.float32)
    ints = np.ascontiguousarray(params.ints, np.int64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        key = (dev.index, stream.cuda_stream, n_ctl)
        if key not in _ctl:
            _ctl[key] = torch.zeros(n_ctl, dtype=torch.int64, device=dev)
        ctl = _ctl[key]
        lists = torch.empty((2, w), dtype=torch.int32, device=dev)
        err = lib.trt_wave_advance_launch(
            table.data_ptr(), sentinel, width, k, regs, LEAF_FORMATS[fmt],
            max(1, passes), plan["staged_rows"], plan["grid"],
            floats.ctypes.data, ints.ctypes.data,
            ctypes.addressof(host_ptrs), w, budget, int(rounds_before),
            ctl.data_ptr(), lists.data_ptr(), rows.data_ptr(),
            stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"wave_advance kernel launch failed: CUDA error "
                           f"{err}")
    wave_advance_cuda.launches += 1
    wave_advance_cuda.plan = plan
    return read_counters(ctl)


wave_advance_cuda.launches = 0
wave_advance_cuda.plan = None


def read_counters(ctl) -> tuple:
    """(rounds run, lanes not DONE) from a launch's counters: the one
    read of a ``wave_advance_cuda`` call, and the first point of a step
    on the card that waits for it (chip_smoke.py runs a step up to here
    with synchronizing calls refused)."""
    ran, live = ctl[-2:].tolist()
    return ran, live


def wave_advance_plain(s, inline, fr, totals, rows, max_rounds=None, *,
                       passes: int = 1, rounds_before: int = 0,
                       lane_rounds=None) -> tuple:
    """The plain version of ``wave_advance_cuda``, on the state's own
    device: rounds of ``walk_plain`` over ``inline.walk`` and then
    ``service_plain`` (engine/persistent.py) on every lane, while a lane
    is live and at most ``max_rounds`` of them, each lane counting the
    rounds it is live at the start of.  ``fr`` is the wave's
    engine/persistent.py ``_Frame`` (what ``service_params`` packs for
    the kernel).  Updates ``s``, ``totals`` and ``rows`` in place; adds
    each lane's rounds to ``lane_rounds`` (int64 [lanes]) when given.
    Returns (rounds run, lanes not DONE)."""
    from tryraytrace_tpu_torch.engine.persistent import service_plain
    budget = _budget(max_rounds)
    k, fmt = fr.scene.leaf_size, fr.scene.leaf_fmt
    ran_by_lane = torch.zeros_like(s["mode"])
    state = dict(s)
    ran = 0
    while ran < budget:
        live = state["mode"] != walk.DONE
        if not bool(live.any()):
            break
        ran_by_lane += live
        state, n = walk.walk_plain(state, inline.walk, inline.sentinel, k,
                                   passes, fmt=fmt)
        rows += n
        state = service_plain(state, inline, fr, totals,
                              (rounds_before + ran) % 2)
        ran += 1
    for key, val in state.items():
        if s[key] is not val:
            s[key].copy_(val)
    if lane_rounds is not None:
        lane_rounds += ran_by_lane
    rounds = int(ran_by_lane.max()) if ran_by_lane.numel() else 0
    return rounds, int((state["mode"] != walk.DONE).sum())

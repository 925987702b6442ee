"""The walk half of the persistent engine's step: the hand-written CUDA
kernel that runs a lane's whole walk in one launch, and its plain
PyTorch version.

A lane in mode TRAVERSE (closest hit) or SHADOW (any hit along an NEE
segment) fetches one quad row of the unified table per step
(tryraytrace_tpu/engine/persistent.py ``_step_quad``, XLA-fused ``jnp``
on the TPU, not a Pallas kernel): a leaf row tests its K triangles
(Baldwin-Weber or Moller-Trumbore slots, ``LEAF_FORMATS``), an internal
row its four child boxes, and the skip-register
file redirects the walk past siblings it already knows it missed.  When
the walk ends the lane's mode says what it needs next: SHADEG (shade
the hit) or REFILL (the path is over) after a closest-hit walk; after a
shadow walk the pending NEE radiance is added if nothing occluded it
and the lane resumes its already chosen bounce (TRAVERSE) or ends
(REFILL).

``walk_step`` is one such step for every lane at once; the engine's
interleaved loop (its plain version of a whole frame) calls it once per
iteration with the row fetch it shares with the service block.
``walk_plain`` repeats it until no lane is TRAVERSE or SHADOW.
``quad_walk_cuda`` (csrc/quad_walk.cu) does the same in one launch of
persistent blocks whose threads take lanes until none is left, over
the walk-order copy of the quad rows with its top levels in shared
memory.  The walk draws no random numbers and the lanes are
independent, so a walk run to its end gives a lane the state the same
walk gives it one row per iteration, and it finds the same rows in
either table (accel/bvh.py ``walk_order_table``).

Both return the number of rows fetched, summed over the lanes, as an
int64 tensor.

``quad_walk`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; there is no fallback between the two.

Signed zeros: the plain step adds ``where(lit, pend, 0.0)`` to every
lane's ``rad``, which turns a ``-0.0`` there into ``+0.0``; the kernel
adds it to the lanes whose shadow walk ended and leaves every other
lane's ``rad`` as it is.  The two are held equal as numbers
(``-0.0 == 0.0``), which is all the image can see.
"""

from __future__ import annotations

import ctypes

import torch

from tryraytrace_tpu_torch.accel.bvh import LEAF_FORMATS, quad_row_width
from tryraytrace_tpu_torch.ops._build import KernelLibrary
from tryraytrace_tpu_torch.ops.traverse import (MISS_T, _fat_leaf_intersect,
                                                _quad_decode, _regfile_apply,
                                                ray_octant)

# Lane modes, numbered as in the JAX engine (its tick-path mode READY,
# 2, does not occur on the inline path).
TRAVERSE = 0
SHADOW = 1
REFILL = 3
DONE = 4
SHADEG = 5
TEXG = 6

# Skip-register counts the kernel is compiled for (its template
# argument): none, and the engine's default (config.py ``quad_regs``).
KERNEL_REGS = (0, 3)

# The state fields the walk writes.
WRITES = ("mode", "cur", "d_min", "hit_id", "rad")


def walk_inv(ls3, rd):
    """Per-lane inverse direction: the closest-hit walk's sign-preserving
    safe inverse, the shadow walk's plain reciprocal (one division)."""
    tiny = (torch.abs(rd) < 1e-8) & ~ls3
    q = 1.0 / torch.where(tiny, 1.0, rd)
    big = torch.where(rd >= 0, 1e20, -1e20)
    return torch.where(tiny, big, q)


def walk_index(s, sentinel: int):
    """(row index [w], stepping [w]): the quad row each TRAVERSE or
    SHADOW lane fetches this step (row 0 for the others)."""
    stepping = (s["mode"] == TRAVERSE) | (s["mode"] == SHADOW)
    idx = torch.where(stepping, torch.clamp(s["cur"], max=sentinel - 1), 0)
    return idx, stepping


def walk_step(s, row, sentinel: int, k: int, passes: int = 1, *,
              fmt: str) -> dict:
    """One quad-row step of every TRAVERSE and SHADOW lane on its fetched
    ``row`` (the rows of ``walk_index``; other lanes' rows are ignored).
    ``k`` is the leaf size, ``fmt`` the leaf slot format, ``passes`` the
    redirect sweeps over the skip registers.  Returns the state after
    the step."""
    mode = s["mode"]
    live_t = mode == TRAVERSE
    live_s = mode == SHADOW
    stepping = live_t | live_s

    use_regs = "reg_e" in s
    if use_regs:
        fresh = ((s["cur"] == 0) & stepping)[:, None]
        reg_e = torch.where(fresh, -1, s["reg_e"])
        reg_s = torch.where(fresh, -1, s["reg_s"])

    ls3 = live_s[:, None]
    ro = torch.where(ls3, s["so"], s["o"])
    rd = torch.where(ls3, s["sd"], s["d"])
    inv = walk_inv(ls3, rd)
    t_min = torch.where(live_s, 1e-3, 0.0)
    octant = ray_octant(rd)

    prim_start = row[:, 0].to(torch.int64)
    is_leaf = prim_start >= 0

    thi = torch.where(live_s, s["smax"] - 1e-3, s["d_min"])
    best_t, best_id = _fat_leaf_intersect(row, k, ro, rd, prim_start,
                                          t_min, thi, fmt=fmt)
    found = stepping & is_leaf & (best_id >= 0)
    d_min = torch.where(found & live_t, best_t, s["d_min"])
    hit_id = torch.where(found & live_t, best_id, s["hit_id"])
    occluded = found & live_s

    t_max = torch.where(live_s, s["smax"], d_min)
    cont, nxt_int, pushes = _quad_decode(row, octant, ro, inv, t_min, t_max)
    nxt = torch.where(is_leaf, cont, nxt_int)
    if use_regs:
        reg_e, reg_s, nxt = _regfile_apply(reg_e, reg_s, pushes, nxt,
                                           stepping, ~is_leaf & stepping,
                                           passes=passes)
    cur = torch.where(stepping, nxt, s["cur"])

    t_done = live_t & (cur >= sentinel)
    s_done = live_s & (occluded | (cur >= sentinel))
    lit = s_done & ~occluded
    rad = s["rad"] + torch.where(lit[:, None], s["pend"], 0.0)

    # A finished walk shades on the next service pass (in the interleaved
    # loop its material row rides the next row fetch); a miss ends the
    # path (renderer.cu:427).  A finished shadow ray resumes the
    # already-chosen next bounce unless the path ended at this bounce.
    mode = torch.where(t_done, torch.where(hit_id >= 0, SHADEG, REFILL), mode)
    mode = torch.where(s_done, torch.where(s["cont_after_shadow"], TRAVERSE,
                                           REFILL), mode)
    cur = torch.where(s_done, 0, cur)
    d_min = torch.where(s_done, MISS_T, d_min)
    hit_id = torch.where(s_done, -1, hit_id)

    out = dict(s)
    out.update(mode=mode, cur=cur, d_min=d_min, hit_id=hit_id, rad=rad)
    if use_regs:
        out.update(reg_e=reg_e, reg_s=reg_s)
    return out


def walk_plain(s, table, sentinel: int, k: int, passes: int = 1, *,
               fmt: str):
    """The plain PyTorch version of the kernel: ``walk_step`` repeated
    until no lane is TRAVERSE or SHADOW, over leaf slots of format
    ``fmt``.  ``s`` is the engine's lane
    state (engine/persistent.py ``init_lane_ctx``), with or without the
    skip-register fields.  Returns (state', rows fetched as an int64
    tensor)."""
    rows = torch.zeros((), dtype=torch.int64, device=table.device)
    while True:
        idx, stepping = walk_index(s, sentinel)
        n = stepping.sum()
        if int(n) == 0:
            return s, rows
        rows = rows + n
        s = walk_step(s, table[idx], sentinel, k, passes, fmt=fmt)


LIBRARY = KernelLibrary("quad_walk", {
    "trt_quad_walk_plan": (
        # sentinel, row width, regs, leaf format, rows per top level
        # (host array), levels, plan (host array)
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p),
    "trt_quad_walk_launch": (
        # table, sentinel, row width, leaf size, regs, leaf format,
        # passes, staged rows, grid, lanes
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong,
        # mode, cur, hit_id, d_min, rad (read and written)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        # o, d, so, sd, smax, pend, cont_after_shadow (read)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        # counters (claimed lanes, rows fetched), stream
        ctypes.c_void_p, ctypes.c_void_p)})

_FIELDS = (("mode", torch.int64, 1), ("cur", torch.int64, 1),
           ("hit_id", torch.int64, 1), ("d_min", torch.float32, 1),
           ("rad", torch.float32, 3), ("o", torch.float32, 3),
           ("d", torch.float32, 3), ("so", torch.float32, 3),
           ("sd", torch.float32, 3), ("smax", torch.float32, 1),
           ("pend", torch.float32, 3), ("cont_after_shadow", torch.bool, 1))
_PLAN = ("staged_rows", "shared_bytes", "grid", "blocks_per_sm", "threads")
# Launch plans by (library, device, regs, leaf format, width, sentinel,
# levels): they depend on nothing else, so each is worked out once.
_plans = {}


def launch_plan(library, plan_fn, dev, regs: int, fmt: str, width: int,
                sentinel: int, levels: tuple) -> dict:
    """The launch plan of a kernel over walk-order rows (``plan_fn``, its
    library's ``trt_..._plan`` entry point; this kernel's or the wave
    kernel's), worked out once per (library, device, regs, leaf format,
    width, sentinel, levels)."""
    key = (library.path, dev.index, regs, fmt, width, sentinel, levels)
    if key not in _plans:
        host_levels = (ctypes.c_longlong * max(1, len(levels)))(*levels)
        out = (ctypes.c_int * len(_PLAN))()
        with torch.cuda.device(dev):
            err = plan_fn(sentinel, width, regs, LEAF_FORMATS[fmt],
                          ctypes.addressof(host_levels), len(levels),
                          ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"{library.name} kernel cannot be planned: "
                               f"CUDA error {err}")
        _plans[key] = dict(zip(_PLAN, out))
    return _plans[key]


def check_table(table, sentinel: int, k: int, fmt: str, levels,
                who: str) -> tuple:
    """Refuse, for the wrapper ``who``, a walk-order table the walk's
    device code cannot take (see ``quad_walk_cuda``); returns (row width,
    levels as a tuple of ints)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {dev}")
    if (table.dim() != 2 or table.dtype != torch.float32
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous [rows, width] float32 "
                         "tensor")
    width = table.shape[1]
    if width % 4 or table.data_ptr() % 16:
        raise ValueError(f"the kernel reads 16-byte rows: a row of {width} "
                         "floats, or a table not 16-byte aligned, is not "
                         "one (walk_order_table pads the rows)")
    if not 0 < sentinel <= table.shape[0]:
        raise ValueError(f"sentinel {sentinel} outside the table's "
                         f"{table.shape[0]} rows")
    if fmt not in LEAF_FORMATS:
        raise ValueError(f"unknown leaf format {fmt!r} (the kernel is "
                         f"built for {sorted(LEAF_FORMATS)})")
    if k < 1 or quad_row_width(k, fmt) > width:
        raise ValueError(f"rows of {width} floats cannot hold quad rows "
                         f"with {k} {fmt!r} triangles per leaf")
    levels = tuple(int(v) for v in levels)
    if min(levels, default=0) < 0 or sum(levels) > sentinel:
        raise ValueError(f"levels {list(levels)} are not the top of a tree "
                         f"of {sentinel} rows")
    return width, levels


def state_regs(s) -> int:
    """The skip registers of lane state ``s`` (``reg_e``'s columns, 0
    without it), refused unless the kernels are built for that count."""
    regs = s["reg_e"].shape[1] if "reg_e" in s else 0
    if regs not in KERNEL_REGS:
        raise ValueError(f"the kernel is built for {KERNEL_REGS} skip "
                         f"registers, the state has {regs}")
    return regs


def quad_walk_cuda(s, table, sentinel: int, k: int, passes: int = 1,
                   levels=(), *, fmt: str):
    """Launch the walk kernel on the current stream.

    ``s`` holds the engine's lane state on the table's CUDA device, every
    field contiguous.  ``table`` is the walk-order copy of the quad rows
    (accel/bvh.py ``walk_order_table``): [rows, width] float32,
    contiguous, 16-byte aligned, ``width`` a multiple of 4, its first
    ``sentinel`` rows quad rows with ``k`` triangles of format ``fmt``
    per leaf.
    ``levels`` are the rows of its top tree levels, as
    ``walk_order_table`` gives them; each block stages the most whole
    levels of them that fit in shared memory (none when empty).  The
    launch's plan is worked out once per table and device.  The skip
    registers (as many as the state's ``reg_e`` has columns, one of
    KERNEL_REGS; none without that field) live in the thread and
    ``reg_e`` / ``reg_s`` themselves are neither read nor written.  That
    is the plain version's result only for walks that start with an
    empty file, so with registers every TRAVERSE or SHADOW lane must
    stand at row 0, as the engine's always do between rounds; a state
    caught mid-walk raises (the one check that waits for the device).
    The five fields the walk writes are copied first, so ``s`` itself is
    left as it was.  The launch's shape is left in
    ``quad_walk_cuda.plan``.  Returns (state', rows fetched as an int64
    tensor)."""
    dev = table.device
    width, levels = check_table(table, sentinel, k, fmt, levels,
                                "quad_walk_cuda")
    regs = state_regs(s)
    w = s["mode"].shape[0]
    for name, dtype, cols in _FIELDS:
        t = s[name]
        shape = (w,) if cols == 1 else (w, cols)
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"state field {name!r} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    walking = (s["mode"] == TRAVERSE) | (s["mode"] == SHADOW)
    if regs and bool((walking & (s["cur"] != 0)).any()):
        raise ValueError("a TRAVERSE or SHADOW lane stands mid-walk (cur != "
                         "0): its skip registers are not in the kernel")
    library = LIBRARY
    lib = library.load()
    out = dict(s)
    for name in WRITES:
        out[name] = s[name].clone()
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    if w > 0:
        plan = dict(launch_plan(library, lib.trt_quad_walk_plan, dev, regs,
                                fmt, width, sentinel, levels))
        plan["grid"] = min(plan["grid"], -(-w // plan["threads"]))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.trt_quad_walk_launch(
                table.data_ptr(), sentinel, width, k, regs,
                LEAF_FORMATS[fmt], max(1, passes),
                plan["staged_rows"], plan["grid"], w,
                out["mode"].data_ptr(), out["cur"].data_ptr(),
                out["hit_id"].data_ptr(), out["d_min"].data_ptr(),
                out["rad"].data_ptr(), s["o"].data_ptr(), s["d"].data_ptr(),
                s["so"].data_ptr(), s["sd"].data_ptr(), s["smax"].data_ptr(),
                s["pend"].data_ptr(), s["cont_after_shadow"].data_ptr(),
                counters.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"quad_walk kernel launch failed: CUDA "
                               f"error {err}")
        quad_walk_cuda.launches += 1
        quad_walk_cuda.plan = plan
    return out, counters[1]


quad_walk_cuda.launches = 0
quad_walk_cuda.plan = None


def quad_walk(s, table, sentinel: int, k: int, passes: int = 1, levels=(),
              *, fmt: str):
    """Run every TRAVERSE and SHADOW lane's walk to its end on the
    table's own device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (``table`` then the walk-order copy and
    ``levels`` its top levels).  ``fmt`` is the leaf slot format.
    Returns (state', rows fetched)."""
    if table.device.type == "cpu":
        return walk_plain(s, table, sentinel, k, passes, fmt=fmt)
    return quad_walk_cuda(s, table, sentinel, k, passes, levels, fmt=fmt)

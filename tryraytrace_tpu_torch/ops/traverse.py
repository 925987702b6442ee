"""BVH traversal on torch tensors: the quad walk of the persistent
engine and the threaded walk of the bounce engine.

The counterpart of the quad and threaded walks in
tryraytrace_tpu/ops/traverse.py (table layouts: accel/bvh.py
``pack_quad_table`` and ``pack_traversal_table``).  A fetched internal
row tests its four child boxes and jumps to the first hit child in
per-octant front-to-back order; later siblings the walk knows it
missed enter a per-lane skip-register file (entry -> thread
successor), which redirects the walk past them when the thread would
enter them.  Leaf rows hold up to K triangles in one of two slot
formats: Baldwin-Weber ("bw", 12 floats) or Moller-Trumbore
(v0, e1, e2) ("mt", 9 floats).

The JAX kernels unroll over the four children and K leaf slots; here
those axes are tensor axes.  Each choice keeps the JAX rule exactly:
the first hit position wins, the lowest leaf slot wins a tie in t,
and the pushes and redirects run in the JAX order.

The threaded walk (``closest_hit_packed``, ``any_hit_packed``) fetches
one binary-tree row per lane per step and follows the row's
per-octant links: the near child after a hit internal box, else the
thread's miss link.  These two are the plain versions of the bounce
engine's CUDA kernel (ops/threaded.py, csrc/threaded_walk.cu), step for
step the JAX functions.
"""

from __future__ import annotations

import numpy as np
import torch

from tryraytrace_tpu_torch.accel.bvh import (LEAF_STRIDE, QB_ENT, QB_NSLOTS,
                                             QUAD_COL_BODY, QUAD_COL_CONT,
                                             QUAD_WIDTH)
from tryraytrace_tpu_torch.core import vec
from tryraytrace_tpu_torch.ops.aabb import aabb_hit
from tryraytrace_tpu_torch.ops.intersect import (baldwin_intersect,
                                                 moller_trumbore_pre)

MISS_T = float(np.float32(1e20))  # renderer.cu:380
QUAD_REGS = 3


def _col(x):
    """A per-lane [N] bound as an [N, 1] column; scalars pass through."""
    return x[:, None] if isinstance(x, torch.Tensor) and x.dim() == 1 else x


def ray_octant(r_d) -> torch.Tensor:
    """Direction octant (bit k set iff d_k < 0) -> int64 [N]."""
    neg = (r_d < 0).to(torch.int64)
    return neg[..., 0] | (neg[..., 1] << 1) | (neg[..., 2] << 2)


def _fat_leaf_intersect(row, k: int, r_o, r_d, prim_start, tlo, thi, *,
                        fmt: str, base: int = QUAD_COL_BODY):
    """Closest (t, prim_id) among the K leaf slots (format ``fmt``) that
    start at column ``base`` of each gathered row (a quad row's by
    default), inside the open window (tlo, thi).  All-zero pad slots
    miss by themselves; internal rows (prim_start < 0) report a miss."""
    st = LEAF_STRIDE[fmt]
    slots = row[:, base:base + st * k].unflatten(1, (k, st))
    ro, rd = r_o[:, None, :], r_d[:, None, :]
    if fmt == "bw":
        t = baldwin_intersect(slots, ro, rd)
    else:
        t = moller_trumbore_pre(slots[..., 0:3], slots[..., 3:6],
                                slots[..., 6:9], ro, rd)
    ok = (t > _col(tlo)) & (t < _col(thi))
    # The JAX loop takes slot j when t_j < best so far: the minimum t
    # over the window, lowest slot on a tie -- which is what min(dim)
    # returns (the first minimal index).
    best_t, j = torch.where(ok, t, MISS_T).min(dim=1)
    is_leaf = prim_start >= 0
    found = is_leaf & (best_t < MISS_T)
    return (torch.where(found, best_t, MISS_T),
            torch.where(found, prim_start + j, -1))


def _quad_decode(row, octant, r_o, inv_d, t_min, t_max):
    """Internal-row decode: (cont, nxt_int, pushes).

    ``cont`` is the row's continuation for the lane's octant, ``nxt_int``
    the first hit child's entry row (``cont`` if none hit), and
    ``pushes`` a list of (push, target, successor) in the JAX order
    (farthest first): push is true for a valid sibling that lies after
    a hit child in front-to-back order but was itself missed."""
    cpi = row[:, QUAD_COL_CONT:QUAD_COL_CONT + 8].gather(
        1, octant[:, None])[:, 0].to(torch.int64)
    cont = cpi >> 8
    perm = cpi & 255
    b = QUAD_COL_BODY
    boxes = row[:, b:b + 6 * QUAD_WIDTH].unflatten(1, (QUAD_WIDTH, 6))
    hits_c = aabb_hit(boxes, r_o[:, None, :], inv_d[:, None, :],
                      _col(t_min), _col(t_max))
    ents_c = row[:, b + QB_ENT:b + QB_ENT + QUAD_WIDTH].to(torch.int64)
    nsl = torch.clamp(row[:, b + QB_NSLOTS], 0, 4).to(torch.int64)

    pos = torch.arange(QUAD_WIDTH, device=row.device)
    slot = (perm[:, None] >> (2 * pos)) & 3      # position -> child slot
    valid = pos < nsl[:, None]
    hit_p = hits_c.gather(1, slot) & valid
    ent_p = ents_c.gather(1, slot)

    first = hit_p.to(torch.int8).argmax(dim=1, keepdim=True)
    nxt_int = torch.where(hit_p.any(dim=1), ent_p.gather(1, first)[:, 0],
                          cont)

    # A hit at an earlier position, for positions 1..3 (written out: a
    # cumsum over this short axis is a slow scan kernel on the card).
    h0, h1, h2 = hit_p[:, 0], hit_p[:, 1], hit_p[:, 2]
    h01 = h0 | h1
    before = torch.stack([h0, h01, h01 | h2], dim=1)
    succ = torch.where(pos[1:] + 1 < nsl[:, None],
                       torch.cat([ent_p[:, 2:], cont[:, None]], dim=1),
                       cont[:, None])
    push = before & ~hit_p[:, 1:] & valid[:, 1:]
    pushes = [(push[:, i], ent_p[:, i + 1], succ[:, i])
              for i in range(QUAD_WIDTH - 2, -1, -1)]
    return cont, nxt_int, pushes


def _regfile_apply(reg_e, reg_s, pushes, nxt, live, gate, passes: int = 2):
    """Advance the skip-register file [n, R]: shift-push each (push,
    target, succ) in order, then redirect ``nxt`` past known-missed
    entries (``passes`` sweeps over the file), consuming matches."""
    for push, tgt, succ in pushes:
        p = (push & gate)[:, None]
        reg_e = torch.where(p, torch.cat([tgt[:, None], reg_e[:, :-1]], 1),
                            reg_e)
        reg_s = torch.where(p, torch.cat([succ[:, None], reg_s[:, :-1]], 1),
                            reg_s)
    es = list(reg_e.unbind(1))
    for _ in range(max(1, passes)):
        for r in range(len(es)):
            m = live & (es[r] >= 0) & (nxt == es[r])
            nxt = torch.where(m, reg_s[:, r], nxt)
            es[r] = torch.where(m, -1, es[r])
    return torch.stack(es, 1), reg_s, nxt


def quad_step(table, k: int, r_o, r_d, inv_d, octant, cur, reg_e, reg_s,
              t_min, t_max, tlo, thi, live, passes: int = 2, *,
              fmt: str):
    """One quad-row step shared by the closest/any-hit walks over leaf
    slots of format ``fmt``: returns (cur', reg_e', reg_s', leaf_t,
    leaf_id)."""
    sentinel = table.shape[0]
    idx = torch.where(live, torch.clamp(cur, max=sentinel - 1), 0)
    row = table[idx]
    prim_start = row[:, 0].to(torch.int64)
    is_leaf = prim_start >= 0
    lt, lid = _fat_leaf_intersect(row, k, r_o, r_d, prim_start, tlo, thi,
                                  fmt=fmt)
    lid = torch.where(live & is_leaf, lid, -1)
    cont, nxt_int, pushes = _quad_decode(row, octant, r_o, inv_d,
                                         t_min, t_max)
    nxt = torch.where(is_leaf, cont, nxt_int)
    if reg_e is not None:
        reg_e, reg_s, nxt = _regfile_apply(reg_e, reg_s, pushes, nxt, live,
                                           ~is_leaf & live, passes=passes)
    cur = torch.where(live, nxt, cur)
    return cur, reg_e, reg_s, lt, lid


def closest_hit_quad(table, k: int, r_o, r_d, active, *, fmt: str):
    """Closest-hit via the quad walk over leaf slots of format ``fmt`` ->
    (t [N], prim id [N]; 1e20 / -1 on a miss)."""
    n = r_o.shape[0]
    sentinel = table.shape[0]
    d_min = torch.full((n,), MISS_T, device=r_o.device)
    hit_id = torch.full((n,), -1, dtype=torch.int64, device=r_o.device)
    if sentinel == 0:
        return d_min, hit_id
    inv_d = vec.safe_inv(r_d)
    octant = ray_octant(r_d)
    cur = torch.where(active, 0, sentinel).to(torch.int64)
    reg = torch.full((n, QUAD_REGS), -1, dtype=torch.int64,
                     device=r_o.device)
    reg_e, reg_s = reg, reg
    while bool((cur < sentinel).any()):
        live = cur < sentinel
        cur, reg_e, reg_s, lt, lid = quad_step(
            table, k, r_o, r_d, inv_d, octant, cur, reg_e, reg_s,
            0.0, d_min, 0.0, d_min, live, fmt=fmt)
        take = lid >= 0
        d_min = torch.where(take, lt, d_min)
        hit_id = torch.where(take, lid, hit_id)
    return d_min, hit_id


def any_hit_quad(table, k: int, r_o, r_d, max_dist, active, *, fmt: str):
    """Shadow traversal via the quad walk over leaf slots of format
    ``fmt`` (trace_shadow parity: plain 1/d, constant (1e-3, max_dist)
    window, early exit) -> occluded [N]."""
    n = r_o.shape[0]
    sentinel = table.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=r_o.device)
    if sentinel == 0:
        return occ
    inv_d = 1.0 / r_d
    octant = ray_octant(r_d)
    cur = torch.where(active, 0, sentinel).to(torch.int64)
    reg = torch.full((n, QUAD_REGS), -1, dtype=torch.int64,
                     device=r_o.device)
    reg_e, reg_s = reg, reg
    while bool((cur < sentinel).any()):
        live = cur < sentinel
        cur, reg_e, reg_s, _, lid = quad_step(
            table, k, r_o, r_d, inv_d, octant, cur, reg_e, reg_s,
            1e-3, max_dist, 1e-3, max_dist - 1e-3, live, fmt=fmt)
        occ = occ | (lid >= 0)
        cur = torch.where(occ, sentinel, cur)
    return occ


# --- Threaded walk (the bounce engine's; accel/bvh.py
# pack_traversal_table rows: box 0:6, K leaf slots from column 6,
# prim_start, prim_count, next_hit[8], next_miss[8]) ---


def _mux8(octant, cols):
    """Column ``octant`` of the eight per-octant columns ``cols``: a pure
    selection, as the JAX select tree is."""
    return torch.stack(cols, 1).gather(1, octant[:, None])[:, 0]


def _decode_links(row, octant, k: int, *, fmt: str):
    """Per-lane (next_hit, next_miss) node ids from a threaded row's 16
    octant-link columns."""
    col = 6 + LEAF_STRIDE[fmt] * k + 2
    nh = _mux8(octant, [row[:, col + o] for o in range(8)])
    nm = _mux8(octant, [row[:, col + 8 + o] for o in range(8)])
    return nh.to(torch.int64), nm.to(torch.int64)


def _leaf_intersect(row, k: int, r_o, r_d, prim_start, tlo, thi, *,
                    fmt: str):
    """Closest (t, prim_id) among a threaded row's K inline leaf slots
    inside the open window (tlo, thi); slots are tested in order and the
    lowest wins a tie (the JAX strict-< update); internal rows miss."""
    return _fat_leaf_intersect(row, k, r_o, r_d, prim_start, tlo, thi,
                               fmt=fmt, base=6)


def _threaded_rows(table, cur, sentinel: int, live, k: int, fmt: str):
    """This step's rows of the live lanes (row 0 for the others) and
    their prim_start."""
    row = table[torch.where(live, torch.clamp(cur, max=sentinel - 1), 0)]
    col_ps = 6 + LEAF_STRIDE[fmt] * k
    return row, row[:, col_ps].to(torch.int64)


def closest_hit_packed(table, k: int, r_o, r_d, active, *, fmt: str):
    """Closest hit over the threaded table [M, stride * K + 24] ->
    (t [N] f32, prim id [N] int64; 1e20 / -1 on a miss, rows fetched as
    an int64 tensor).  JAX
    ``closest_hit_packed``: the safe inverse direction, the box window
    (0, d_min), leaf slots in order with the strict-< update inside
    (0, d_min), then the near child after a hit internal box, else the
    miss link, by the ray's octant."""
    n = r_o.shape[0]
    sentinel = table.shape[0]
    d_min = torch.full((n,), MISS_T, device=r_o.device)
    hit_id = torch.full((n,), -1, dtype=torch.int64, device=r_o.device)
    rows = torch.zeros((), dtype=torch.int64, device=r_o.device)
    if sentinel == 0:
        return d_min, hit_id, rows
    inv_d = vec.safe_inv(r_d)
    octant = ray_octant(r_d)
    cur = torch.where(active, 0, sentinel).to(torch.int64)
    while True:
        live = cur < sentinel
        n_live = live.sum()
        if not bool(n_live):
            break
        rows = rows + n_live
        row, prim_start = _threaded_rows(table, cur, sentinel, live, k, fmt)
        hit = aabb_hit(row[:, :6], r_o, inv_d, 0.0, d_min) & live
        is_leaf = prim_start >= 0
        lt, lid = _leaf_intersect(row, k, r_o, r_d, prim_start, 0.0, d_min,
                                  fmt=fmt)
        take = hit & is_leaf & (lid >= 0)
        d_min = torch.where(take, lt, d_min)
        hit_id = torch.where(take, lid, hit_id)
        nh, nm = _decode_links(row, octant, k, fmt=fmt)
        cur = torch.where(live, torch.where(hit & ~is_leaf, nh, nm),
                          sentinel)
    return d_min, hit_id, rows


def any_hit_packed(table, k: int, r_o, r_d, max_dist, active, *, fmt: str):
    """Shadow traversal over the threaded table -> (occluded [N] bool,
    rows fetched as an int64 tensor).  JAX
    ``any_hit_packed`` (trace_shadow parity): the plain 1/d, the box
    window (1e-3, max_dist), the leaf window (1e-3, max_dist - 1e-3), and
    the walk stops at the first occluder."""
    n = r_o.shape[0]
    sentinel = table.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=r_o.device)
    rows = torch.zeros((), dtype=torch.int64, device=r_o.device)
    if sentinel == 0:
        return occ, rows
    inv_d = 1.0 / r_d
    octant = ray_octant(r_d)
    cur = torch.where(active, 0, sentinel).to(torch.int64)
    while True:
        live = cur < sentinel
        n_live = live.sum()
        if not bool(n_live):
            break
        rows = rows + n_live
        row, prim_start = _threaded_rows(table, cur, sentinel, live, k, fmt)
        hit = aabb_hit(row[:, :6], r_o, inv_d, 1e-3, max_dist) & live
        is_leaf = prim_start >= 0
        _, lid = _leaf_intersect(row, k, r_o, r_d, prim_start, 1e-3,
                                 max_dist - 1e-3, fmt=fmt)
        occ = occ | (hit & is_leaf & (lid >= 0))
        nh, nm = _decode_links(row, octant, k, fmt=fmt)
        cur = torch.where(live & ~occ, torch.where(hit & ~is_leaf, nh, nm),
                          sentinel)
    return occ, rows

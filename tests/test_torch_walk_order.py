"""The walk-order copy of the quad rows (accel/bvh.py
``walk_order_table``), which the round loop's walks read: a renaming of
the rows, and a walk over it finds what a walk over the unified table
finds, field for field and row for row.

Tolerance 0 everywhere: the copy renames rows and pads them, and the
walk only tests row ids for equality, for 0 and against the sentinel.
"""

from collections import deque

import numpy as np
import pytest
import torch

from tryraytrace_tpu_torch.accel.bvh import (QB_ENT, QB_NSLOTS, QUAD_COL_BODY,
                                             QUAD_COL_CONT, build_bvh,
                                             collapse_bvh, pack_quad_table,
                                             quad_row_width,
                                             walk_order_table)
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import persistent
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import service, walk
from tryraytrace_tpu_torch.ops.traverse import MISS_T
from tryraytrace_tpu_torch.scene.assets import checker_texture, icosphere_mesh
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, flatten_scene

torch.set_num_threads(1)

N = 2048
ENT = slice(QUAD_COL_BODY + QB_ENT, QUAD_COL_BODY + QB_ENT + 4)
CONT = slice(QUAD_COL_CONT, QUAD_COL_CONT + 8)


def _quad_table(seed, n_tris, k):
    r = np.random.RandomState(seed)
    base = r.uniform(-5, 5, size=(n_tris, 1, 3)).astype(np.float32)
    tri = base + r.uniform(-0.8, 0.8, size=(n_tris, 3, 3)).astype(np.float32)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    bvh = build_bvh(v0, v1, v2, method="sah", leaf_size=k)
    return pack_quad_table(bvh, v0[bvh.perm], v1[bvh.perm], v2[bvh.perm],
                           leaf_size=k,
                           children=collapse_bvh(bvh, criterion="dp")), r


def _bfs(table):
    """Breadth-first row order from row 0, children in slot order, and
    the rows per level, by a plain queue."""
    order, levels = [], []
    queue = deque([(0, 0)])
    while queue:
        row, depth = queue.popleft()
        order.append(row)
        if depth == len(levels):
            levels.append(0)
        levels[depth] += 1
        if table[row, 0] < 0:
            for c in range(int(table[row, QUAD_COL_BODY + QB_NSLOTS])):
                queue.append((int(table[row, ENT][c]), depth + 1))
    return order, levels


@pytest.mark.parametrize("k,n_tris", [(8, 600), (4, 900), (1, 40)])
def test_walk_order_table_renames_the_rows(k, n_tris):
    src, _ = _quad_table(k, n_tris, k)
    n, w = src.shape
    out, levels = walk_order_table(src, k)
    order, want_levels = _bfs(src)
    assert levels == want_levels and sum(levels) == n and levels[0] == 1
    assert sorted(order) == list(range(n)) and order[0] == 0
    assert out.dtype == np.float32 and out.shape == (n, -(-w // 4) * 4)
    assert w == quad_row_width(k) and out.shape[1] % 4 == 0
    assert not out[:, w:].any()
    new_id = {old: new for new, old in enumerate(order)}

    def rename(ids):
        return np.array([new_id[i] if i < n else i for i in ids])

    for new, old in enumerate(order):
        want = src[old].copy()
        if want[0] < 0:
            ents = want[ENT].astype(np.int64)
            want[ENT] = rename(ents)
            ns = int(want[QUAD_COL_BODY + QB_NSLOTS])
            # Used entries are rows, the others the sentinel (kept).
            assert (ents[:ns] < n).all() and (ents[ns:] == n).all()
        packed = want[CONT].astype(np.int64)
        want[CONT] = rename(packed >> 8) * 256 + (packed & 255)
        np.testing.assert_array_equal(out[new, :w], want)
    # Every id inside the copy is a row or the sentinel.
    conts = out[:, CONT].astype(np.int64) >> 8
    ents = out[out[:, 0] < 0][:, ENT].astype(np.int64)
    for ids in (conts, ents):
        assert ((ids >= 0) & (ids <= n)).all()
    # Breadth-first: a row's children come after it, level by level.
    assert (ents[ents < n] > 0).all()


def test_walk_order_table_of_an_empty_table():
    out, levels = walk_order_table(np.zeros((0, quad_row_width(4)),
                                            np.float32), 4)
    assert out.shape == (0, 60) and levels == []
    with pytest.raises(ValueError):
        walk_order_table(np.zeros((3, 50), np.float32), 4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rays(r):
    o = r.uniform(-8, 8, size=(N, 3)).astype(np.float32)
    d = r.uniform(-4, 4, size=(N, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return _t(o), _t(d)


def _state(kind, regs, r):
    """A fresh all-TRAVERSE state, or a mixed one: SHADOW lanes (some
    with a zero direction component: 0 * inf in the slab test, some
    walking on), TRAVERSE, SHADEG and DONE lanes."""
    o, d = _rays(r)
    so, sd = _rays(r)
    sd[::5, 1] = 0.0
    if kind == "fresh":
        mode = torch.full((N,), walk.TRAVERSE)
    else:
        mode = _t(r.choice([walk.TRAVERSE, walk.SHADOW, walk.SHADOW,
                            walk.SHADEG, walk.DONE], N).astype(np.int64))
    s = dict(mode=mode, cur=torch.zeros(N, dtype=torch.int64),
             d_min=torch.full((N,), MISS_T),
             hit_id=torch.full((N,), -1, dtype=torch.int64),
             o=o, d=d, so=so, sd=sd,
             smax=_t(r.uniform(0.5, 12, N).astype(np.float32)),
             pend=_t(r.uniform(0.1, 2, (N, 3)).astype(np.float32)),
             rad=_t(r.uniform(0, 1, (N, 3)).astype(np.float32)),
             cont_after_shadow=_t(r.rand(N) < 0.5))
    if regs:
        s["reg_e"] = torch.full((N, regs), -1, dtype=torch.int64)
        s["reg_s"] = s["reg_e"].clone()
    return s


def _assert_same_walk(a, a_rows, b, b_rows):
    for f in walk.WRITES:
        assert torch.equal(a[f], b[f]), f
    assert a_rows.dtype == torch.int64 and int(a_rows) == int(b_rows)


@pytest.mark.parametrize("kind", ["fresh", "mixed"])
@pytest.mark.parametrize("regs,passes", [(3, 1), (3, 2), (0, 1), (0, 2)])
def test_walk_over_the_copy_equals_walk_over_the_table(kind, regs, passes):
    k = 8
    src, r = _quad_table(11, 700, k)
    table = torch.from_numpy(src)
    copy, _ = walk_order_table(src, k)
    s = _state(kind, regs, r)
    want, want_rows = walk.walk_plain(s, table, table.shape[0], k, passes,
                                      fmt="bw")
    got, rows = walk.walk_plain(s, torch.from_numpy(copy), copy.shape[0], k,
                                passes, fmt="bw")
    _assert_same_walk(got, rows, want, want_rows)
    moved = want["mode"] != s["mode"]
    assert int(moved.sum()) > N // 3 and int(rows) > N


def _icosphere_scene():
    scene = create_cornell_box(mesh=None)
    v0, v1, v2 = icosphere_mesh(2, 15.0)
    off = np.asarray((50.0, 20.0, 50.0), np.float32)
    for a, b, c in zip(v0 + off, v1 + off, v2 + off):
        scene.objects.append(Object(v0=tuple(a), v1=tuple(b), v2=tuple(c),
                                    albedo=(0.75, 0.75, 0.75), metallic=1.0,
                                    roughness=0.1))
    return flatten_scene(scene, textures=[checker_texture(32)])


def test_round_loop_walks_the_copy_and_the_unified_table_agrees(
        monkeypatch):
    """The engine's inline table holds the copy; the round loop's walks
    read it, and every round's walk equals the walk over the quad rows
    of the unified table."""
    w = h = 24
    r = Renderer(_icosphere_scene(), cfg=RenderConfig(width=w, height=h),
                 device="cpu")
    inline, k = r.inline, r.scene.leaf_size
    copy, levels = walk_order_table(r.scene.quad_table.numpy(), k)
    assert torch.equal(inline.walk, torch.from_numpy(copy))
    assert inline.walk_levels == tuple(levels) and levels[:2] == [1, 4]
    assert inline.walk.shape[1] % 4 == 0
    cam = CameraController().get_params(w, h).to("cpu")
    fr = persistent._Frame(r.scene, inline, r.cfg, cam, 1, w, h, 1, 1)
    s = persistent.init_lane_ctx(1, 1, torch.arange(w * h), cam, w, h,
                                 r.cfg, with_tstash=inline.tex0 is not None)
    seen = []
    real = persistent.quad_walk

    def spy(s, table, sentinel, k, passes, levels, *, fmt):
        seen.append((table is inline.walk, levels == inline.walk_levels,
                     fmt == "bw"))
        return real(s, table, sentinel, k, passes, levels, fmt=fmt)

    monkeypatch.setattr(persistent, "quad_walk", spy)
    shadow_rounds = 0
    totals = torch.zeros(len(service.TOTALS), dtype=torch.int64)
    for rnd in range(6):
        want, want_rows = walk.walk_plain(s, inline.table, inline.sentinel,
                                          k, fmt="bw")
        got, rows = walk.walk_plain(s, inline.walk, inline.sentinel, k,
                                    fmt="bw")
        _assert_same_walk(got, rows, want, want_rows)
        shadow_rounds += bool((s["mode"] == walk.SHADOW).any())
        s = persistent._round_quad(s, inline, k, fr, 1, totals, rnd % 2)[0]
    assert seen == [(True, True, True)] * 6 and shadow_rounds >= 2

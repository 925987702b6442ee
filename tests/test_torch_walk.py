"""The walk half of the port's engine step (ops/walk.py): ``walk_plain``
against the port's closest-hit and any-hit quad walks, which
tests/test_torch_ops.py holds against the JAX walks, and the round loop
(walks run to their end, then a service pass) against the interleaved
loop, its plain version; tests/test_torch_renderer.py holds both against
the JAX engine and the round loop against the oracle.

Tolerance 0 everywhere: the walks share one copy of the arithmetic, the
lanes are independent and a walk draws no random numbers, so when a
lane's rows are fetched cannot change what it finds."""

import numpy as np
import pytest
import torch

from tryraytrace_tpu_torch.accel.bvh import (build_bvh, collapse_bvh,
                                             pack_quad_table,
                                             walk_order_table)
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import persistent
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import walk
from tryraytrace_tpu_torch.ops._build import KernelLibrary
from tryraytrace_tpu_torch.ops.traverse import (MISS_T, any_hit_quad,
                                                closest_hit_quad)

from test_torch_renderer import _mesh_scene, _two_textures

torch.set_num_threads(1)

N = 2048
K = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rays(r, n=N):
    """n rays from [-8, 8]^3 aimed at random points of [-4, 4]^3."""
    o = r.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    d = r.uniform(-4, 4, size=(n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return _t(o), _t(d)


def _walk_scene(seed, n_tris, k=K, fmt="bw"):
    """Random triangles in [-5, 5]^3, their quad table (leaf slots of
    format ``fmt``), and rays from [-8, 8]^3 aimed at random points
    among them."""
    r = np.random.RandomState(seed)
    base = r.uniform(-5, 5, size=(n_tris, 1, 3)).astype(np.float32)
    tri = base + r.uniform(-0.8, 0.8, size=(n_tris, 3, 3)).astype(np.float32)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    bvh = build_bvh(v0, v1, v2, method="sah", leaf_size=k)
    table = pack_quad_table(bvh, v0[bvh.perm], v1[bvh.perm], v2[bvh.perm],
                            leaf_size=k,
                            children=collapse_bvh(bvh, criterion="dp"),
                            leaf_fmt=fmt)
    return _t(table), lambda: _rays(r), r


def _state(mode, o, d, so, sd, smax, pend, cont, regs):
    n = mode.shape[0]
    s = dict(mode=mode, cur=torch.zeros(n, dtype=torch.int64),
             d_min=torch.full((n,), MISS_T),
             hit_id=torch.full((n,), -1, dtype=torch.int64),
             o=o, d=d, so=so, sd=sd, smax=smax, pend=pend,
             rad=torch.zeros((n, 3)), cont_after_shadow=cont)
    if regs:
        s["reg_e"] = torch.full((n, regs), -1, dtype=torch.int64)
        s["reg_s"] = s["reg_e"].clone()
    return s


@pytest.mark.parametrize("regs,passes", [(3, 1), (3, 2), (0, 1)])
def test_fresh_walk_matches_closest_hit_quad(regs, passes):
    table, rays, r = _walk_scene(5, 500)
    o, d = rays()
    active = torch.ones(N, dtype=torch.bool)
    active[:64] = False
    mode = torch.where(active, walk.TRAVERSE, walk.DONE)
    zeros3 = torch.zeros((N, 3))
    s = _state(mode, o, d, zeros3, zeros3, torch.zeros(N), zeros3,
               torch.zeros(N, dtype=torch.bool), regs)
    out, rows = walk.walk_plain(s, table, table.shape[0], K, passes,
                                fmt="bw")
    want_t, want_id = closest_hit_quad(table, K, o, d, active, fmt="bw")
    assert torch.equal(out["d_min"], want_t)
    assert torch.equal(out["hit_id"], want_id)
    hit = want_id >= 0
    assert 0.3 < float(hit.float().mean()) < 1.0
    want_mode = torch.where(active, torch.where(hit, walk.SHADEG,
                                                walk.REFILL), walk.DONE)
    assert torch.equal(out["mode"], want_mode)
    assert bool((out["cur"][active] >= table.shape[0]).all())
    assert torch.equal(out["rad"], s["rad"])
    assert rows.dtype == torch.int64 and int(rows) >= int(active.sum())
    # The skip registers only save fetches.
    if regs == 0:
        with_regs, fewer = walk.walk_plain(
            {**s, "reg_e": torch.full((N, 3), -1, dtype=torch.int64),
             "reg_s": torch.full((N, 3), -1, dtype=torch.int64)},
            table, table.shape[0], K, passes, fmt="bw")
        assert int(fewer) < int(rows)
        assert torch.equal(with_regs["hit_id"], want_id)


def test_shadow_walk_matches_any_hit_quad_and_walks_on():
    table, rays, r = _walk_scene(6, 400)
    o, d = rays()
    so, sd = rays()
    smax = _t(r.uniform(0.5, 12, N).astype(np.float32))
    pend = _t(r.uniform(0.1, 2, (N, 3)).astype(np.float32))
    cont = _t(r.rand(N) < 0.5)
    shadow = torch.ones(N, dtype=torch.bool)
    shadow[::97] = False
    mode = torch.where(shadow, walk.SHADOW, walk.REFILL)
    s = _state(mode, o, d, so, sd, smax, pend, cont, 3)
    s["rad"] = _t(r.uniform(0, 1, (N, 3)).astype(np.float32))
    out, rows = walk.walk_plain(s, table, table.shape[0], K, fmt="bw")

    occluded = any_hit_quad(table, K, so, sd, smax, shadow, fmt="bw")
    assert 0.1 < float(occluded.float().mean()) < 0.9
    lit = shadow & ~occluded
    assert torch.equal(out["rad"],
                       s["rad"] + torch.where(lit[:, None], pend, 0.0))
    # A lane whose path continues walks on for its closest hit along
    # (o, d); the others end with the walk fields reset.
    walked_on = shadow & cont
    want_t, want_id = closest_hit_quad(table, K, o, d, walked_on, fmt="bw")
    assert torch.equal(out["d_min"], want_t)
    assert torch.equal(out["hit_id"], want_id)
    want_mode = torch.where(
        walked_on, torch.where(want_id >= 0, walk.SHADEG, walk.REFILL),
        walk.REFILL)
    assert torch.equal(out["mode"], want_mode)
    assert bool((out["cur"][shadow & ~cont] == 0).all())
    assert int(rows) > N


@pytest.mark.parametrize("build", [_mesh_scene, _two_textures])
def test_round_loop_equals_interleaved_loop(build):
    w = h = 32
    r = Renderer(build(), cfg=RenderConfig(width=w, height=h, spp=2),
                 device="cpu")
    cam = CameraController().get_params(w, h)
    want, want_stats = persistent.render_frame_interleaved(
        r.scene, r.inline, cam, 1, w, h, r.cfg, 2)
    out, stats = persistent.render_frame_persistent(
        r.scene, r.inline, cam, 1, w, h, r.cfg, 2)
    assert torch.equal(out, want) and float(out.sum()) > 0.0
    assert float(out.sum()) == float(want.sum())
    assert int(stats["n_traced"]) == int(want_stats["n_traced"]) > w * h * 2
    assert int(stats["n_shadow"]) == int(want_stats["n_shadow"]) > 0
    # A round runs whole walks, so there are far fewer of them than
    # one-row steps; the rows fetched are the same rows.
    assert stats["iterations"] * 3 < want_stats["iterations"]
    assert stats["rows_fetched"].dtype == torch.int64
    assert (int(stats["rows_fetched"]) == int(want_stats["rows_fetched"])
            > int(stats["n_traced"]))


def test_renderer_takes_the_round_loop_on_every_device(monkeypatch):
    """One ``quad_walk`` call per round, on the CPU too: the loop the
    tests hold to the oracle is the loop a card runs."""
    calls = []
    real = persistent.quad_walk

    def spy(s, table, *args, **kwargs):
        calls.append(table.device.type)
        return real(s, table, *args, **kwargs)

    monkeypatch.setattr(persistent, "quad_walk", spy)
    r = Renderer(_mesh_scene(), cfg=RenderConfig(width=8, height=8),
                 device="cpu")
    r.step(CameraController().get_params(8, 8))
    assert calls == ["cpu"] * r.last_stats["iterations"] and calls
    assert int(r.last_stats["rows_fetched"]) > 8 * 8


def test_dispatch_on_cpu_uses_plain_version():
    table, rays, _ = _walk_scene(7, 60)
    o, d = rays()
    zeros3 = torch.zeros((N, 3))
    s = _state(torch.full((N,), walk.TRAVERSE), o, d, zeros3, zeros3,
               torch.zeros(N), zeros3, torch.zeros(N, dtype=torch.bool), 3)
    before = walk.quad_walk_cuda.launches
    got, rows = walk.quad_walk(s, table, table.shape[0], K, fmt="bw")
    want, want_rows = walk.walk_plain(s, table, table.shape[0], K, fmt="bw")
    assert all(torch.equal(got[f], want[f]) for f in walk.WRITES)
    assert int(rows) == int(want_rows)
    assert walk.quad_walk_cuda.launches == before
    with pytest.raises(ValueError):
        walk.quad_walk_cuda(s, table, table.shape[0], K, fmt="bw")


def _card_case(case, fmt="bw"):
    """(state, walk-order table, levels, k) on the card for one kernel
    test case, over leaf slots of format ``fmt``:
      mixed  - every mode, shadow rays with 0 * inf in the slab test;
      done   - 95% of the lanes DONE: threads skip them and refill;
      wide   - 300,000 lanes, more than the grid holds threads, so
               threads take lane after lane;
      deep   - 20,000 triangles at 4 per leaf: the tree's top levels
               outgrow the staged rows, and most rows come from L2."""
    k, n_tris, n = {"deep": (4, 20000, N)}.get(case, (K, 2000, N))
    if case == "wide":
        n = 300000
    table, _, r = _walk_scene(8, n_tris, k, fmt)
    wt, levels = walk_order_table(table.numpy(), k, fmt)
    o, d = _rays(r, n)
    so, sd = _rays(r, n)
    sd[::5, 1] = 0.0  # 0 * inf in the shadow walk's slab test
    modes = [walk.TRAVERSE, walk.SHADOW, walk.SHADEG, walk.DONE]
    p = [0.02, 0.03, 0.0, 0.95] if case == "done" else None
    mode = _t(r.choice(modes, n, p=p).astype(np.int64))
    s = _state(mode, o, d, so, sd,
               _t(r.uniform(0.5, 12, n).astype(np.float32)),
               _t(r.uniform(0.1, 2, (n, 3)).astype(np.float32)),
               _t(r.rand(n) < 0.5), 3)
    s["rad"] = _t(r.uniform(0, 1, (n, 3)).astype(np.float32))
    s = {key: val.cuda() for key, val in s.items()}
    return s, torch.from_numpy(wt).cuda(), levels, k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "done", "wide", "deep"])
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA walk kernel runs only on a CUDA device")
    s, table, levels, k = _card_case(case)
    before = walk.quad_walk_cuda.launches
    got, rows = walk.quad_walk_cuda(s, table, table.shape[0], k, 1, levels,
                                    fmt="bw")
    torch.cuda.synchronize()
    plan = walk.quad_walk_cuda.plan
    assert walk.quad_walk_cuda.launches == before + 1
    want, want_rows = walk.walk_plain(s, table, table.shape[0], k, fmt="bw")
    # -0.0 == 0.0: see the signed-zero note in ops/walk.py.
    for f in walk.WRITES:
        assert bool((got[f] == want[f]).all()), f
    assert int(rows) == int(want_rows)
    # The plan is worked out once per table: a second launch adds none.
    plans = len(walk._plans)
    walk.quad_walk_cuda(s, table, table.shape[0], k, 1, levels, fmt="bw")
    assert len(walk._plans) == plans and walk.quad_walk_cuda.plan == plan
    # Whole levels are staged.
    assert 0 < plan["staged_rows"] <= table.shape[0]
    assert plan["staged_rows"] in np.cumsum(levels)
    if case == "wide":
        assert plan["grid"] * plan["threads"] < s["mode"].shape[0]
    if case == "deep":
        assert plan["staged_rows"] < table.shape[0] // 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "done", "deep"])
def test_cuda_mt_kernel_matches_plain_version(case):
    """The Moller-Trumbore leaf format: 9-float slots, three in a row's
    first 40 floats and the rest (leaf size 8 in "mixed" and "done")
    loaded one float at a time at every 16-byte offset."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA walk kernel runs only on a CUDA device")
    s, table, levels, k = _card_case(case, "mt")
    assert table.shape[1] == -(-(10 + 9 * k) // 4) * 4
    got, rows = walk.quad_walk_cuda(s, table, table.shape[0], k, 1, levels,
                                    fmt="mt")
    want, want_rows = walk.walk_plain(s, table, table.shape[0], k, 1,
                                      fmt="mt")
    for f in walk.WRITES:
        assert bool((got[f] == want[f]).all()), f
    assert int(rows) == int(want_rows)
    assert bool((got["hit_id"] >= 0).any())
    # A leaf size the rows cannot hold is refused.
    with pytest.raises(ValueError, match="cannot hold"):
        walk.quad_walk_cuda(s, table, table.shape[0], k + 1, 1, levels,
                            fmt="mt")


def test_benchmark_builds_of_the_kernel_are_libraries_of_their_own():
    variant = KernelLibrary("quad_walk", walk.LIBRARY.functions,
                            defines=("TRT_WALK_REFILL_IDLE=8",))
    assert "-DTRT_WALK_REFILL_IDLE=8" in variant.flags
    assert variant.source == walk.LIBRARY.source
    assert variant._target() != walk.LIBRARY._target()


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA walk kernel runs only on a CUDA device")
    s, table, levels, k = _card_case("mixed")
    rows = table.shape[0]
    with pytest.raises(ValueError):
        walk.quad_walk_cuda({**s, "o": s["o"].t()}, table, rows, k, 1,
                            levels, fmt="bw")
    # Rows that are not 16 bytes wide (the unpadded quad rows), and a
    # table that does not start on a 16-byte boundary.
    with pytest.raises(ValueError, match="16-byte"):
        walk.quad_walk_cuda(s, table[:, :-2].contiguous(), rows, k, 1,
                            levels, fmt="bw")
    flat = torch.cat([table.new_zeros(1), table.reshape(-1)])
    with pytest.raises(ValueError, match="16-byte"):
        walk.quad_walk_cuda(s, flat[1:].view(table.shape), rows, k, 1,
                            levels, fmt="bw")
    # Levels that are not the top of this tree.
    with pytest.raises(ValueError, match="levels"):
        walk.quad_walk_cuda(s, table, rows, k, 1, [rows, 1], fmt="bw")
    # A lane caught mid-walk has skip registers the kernel cannot see.
    with pytest.raises(ValueError, match="mid-walk"):
        walk.quad_walk_cuda({**s, "cur": torch.ones_like(s["cur"])}, table,
                            rows, k, 1, levels, fmt="bw")
    with pytest.raises(ValueError, match="skip registers"):
        walk.quad_walk_cuda({**s, "reg_e": s["reg_e"][:, :2].contiguous()},
                            table, rows, k, 1, levels, fmt="bw")

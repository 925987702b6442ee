"""The walk-order copy of the threaded rows (accel/bvh.py
``threaded_walk_order_table``), which the bounce engine's walks read: a
renaming of the rows, over which the plain walks (ops/traverse.py
``closest_hit_packed`` / ``any_hit_packed``, the plain versions of
csrc/threaded_walk.cu) find what they find over
``DeviceScene.node_table``, output for output and row for row; and the
engine walks the copy of the table it renders, also after a refit.

Tolerance 0 everywhere: the copy renames rows and pads them, and the
walk tests row ids only against the sentinel.  The ``cuda`` cases run
the kernel on a card and skip elsewhere; this file imports no jax.
"""

from collections import deque

import numpy as np
import pytest
import torch

from tryraytrace_tpu_torch.accel.bvh import (LEAF_STRIDE, build_bvh,
                                             pack_traversal_table,
                                             threaded_walk_order_table,
                                             traversal_row_width)
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import wavefront
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import bounce, threaded
from tryraytrace_tpu_torch.ops.traverse import (any_hit_packed,
                                                closest_hit_packed)
from tryraytrace_tpu_torch.scene.assets import icosphere_mesh
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, flatten_scene

torch.set_num_threads(1)

N = 2048
W, H = 16, 12


def _scene(seed, n_tris, method, leaf_fmt, leaf_size):
    """(threaded table, its BVH, K) of ``n_tris`` seed-made triangles."""
    r = np.random.RandomState(seed)
    base = r.uniform(-5, 5, size=(n_tris, 1, 3)).astype(np.float32)
    tri = base + r.uniform(-0.8, 0.8, size=(n_tris, 3, 3)).astype(np.float32)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    bvh = build_bvh(v0, v1, v2, method=method, leaf_size=leaf_size)
    k = int(max(1, bvh.leaf_count.max()))
    table = pack_traversal_table(bvh, v0[bvh.perm], v1[bvh.perm],
                                 v2[bvh.perm], leaf_size=k,
                                 leaf_fmt=leaf_fmt)
    return table, bvh, k


def _bfs(bvh):
    """Breadth-first node order from the root, left child first, and the
    nodes per level, by a plain queue over the BVH's child links."""
    order, levels = [], []
    queue = deque([(0, 0)])
    while queue:
        node, depth = queue.popleft()
        order.append(node)
        if depth == len(levels):
            levels.append(0)
        levels[depth] += 1
        if bvh.left[node] >= 0:
            queue.append((int(bvh.left[node]), depth + 1))
            queue.append((int(bvh.right[node]), depth + 1))
    return order, levels


@pytest.mark.parametrize("leaf_size", [1, 4, 6])
@pytest.mark.parametrize("leaf_fmt", ["bw", "mt"])
@pytest.mark.parametrize("method", ["sah", "median", "sbvh"])
def test_threaded_walk_order_table_renames_the_rows(method, leaf_fmt,
                                                    leaf_size):
    src, bvh, k = _scene(leaf_size, 300, method, leaf_fmt, leaf_size)
    n, w = src.shape
    out, levels = threaded_walk_order_table(src, k, leaf_fmt)
    order, want_levels = _bfs(bvh)
    assert levels == want_levels and sum(levels) == n and levels[0] == 1
    assert w == traversal_row_width(k, leaf_fmt)
    assert out.dtype == np.float32 and out.shape == (n, -(-w // 4) * 4)
    assert not out[:, w:].any()
    links = slice(6 + LEAF_STRIDE[leaf_fmt] * k + 2, w)
    ids = out[:, links].astype(np.int64)
    # Every link is a row or the sentinel, and the sentinel stays.
    assert ((ids >= 0) & (ids <= n)).all()
    np.testing.assert_array_equal(ids == n, src[order][:, links] == n)
    # Read back through the inverse renaming, each row is the original.
    back = out[:, :w].copy()
    old_of = np.append(np.asarray(order), n)
    back[:, links] = old_of[ids]
    np.testing.assert_array_equal(back, src[order])
    np.testing.assert_array_equal(out[0, :6], src[0, :6])
    # Breadth-first: an internal row's near children lie after it.
    internal = out[:, links.start - 2] < 0
    near = ids[internal, :8]
    rows = np.nonzero(internal)[0]
    assert (near > rows[:, None]).all()


@pytest.mark.parametrize("leaf_fmt", ["bw", "mt"])
def test_threaded_walk_order_table_of_an_empty_and_a_one_node_table(
        leaf_fmt):
    w = traversal_row_width(4, leaf_fmt)
    out, levels = threaded_walk_order_table(np.zeros((0, w), np.float32), 4,
                                            leaf_fmt)
    assert out.shape == (0, -(-w // 4) * 4) and levels == []
    src, _, k = _scene(3, 1, "sah", leaf_fmt, 4)
    assert src.shape[0] == 1
    out, levels = threaded_walk_order_table(src, k, leaf_fmt)
    assert levels == [1]
    np.testing.assert_array_equal(out[:, :src.shape[1]], src)
    assert (out[0, 6 + LEAF_STRIDE[leaf_fmt] * k + 2:src.shape[1]] == 1).all()
    with pytest.raises(ValueError, match="needs"):
        threaded_walk_order_table(np.zeros((3, w + 1), np.float32), 4,
                                  leaf_fmt)


def test_threaded_walk_order_table_refuses_ids_of_2_24_or_more():
    src, _, k = _scene(4, 200, "sah", "bw", 4)
    bad = src.copy()
    bad[5, 6 + 12 * k + 2 + 8] = 2.0 ** 24
    with pytest.raises(ValueError, match="2\\^24"):
        threaded_walk_order_table(bad, k, "bw")
    huge = np.broadcast_to(src[:1], (2 ** 24, src.shape[1]))
    with pytest.raises(ValueError, match="2\\^24"):
        threaded_walk_order_table(huge, k, "bw")


def _rays(seed):
    r = np.random.RandomState(seed)
    o = r.uniform(-8, 8, size=(N, 3)).astype(np.float32)
    d = r.uniform(-4, 4, size=(N, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:16, 1] = 0.0       # the safe inverse and the plain 1/d of zero
    smax = r.uniform(0.5, 12, N).astype(np.float32)
    return (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(smax),
            r)


@pytest.mark.parametrize("active_share", [1.0, 0.1])
@pytest.mark.parametrize("method,leaf_fmt,leaf_size", [
    ("sah", "bw", 4), ("sah", "mt", 6), ("sbvh", "mt", 6), ("median", "bw", 1)])
def test_plain_walks_over_the_copy_equal_walks_over_the_table(
        method, leaf_fmt, leaf_size, active_share):
    src, _, k = _scene(7, 400, method, leaf_fmt, leaf_size)
    copy, _ = threaded_walk_order_table(src, k, leaf_fmt)
    o, d, smax, r = _rays(8)
    active = torch.from_numpy(r.rand(N) < active_share)
    a, b = torch.from_numpy(src), torch.from_numpy(copy)
    want = closest_hit_packed(a, k, o, d, active, fmt=leaf_fmt)
    got = closest_hit_packed(b, k, o, d, active, fmt=leaf_fmt)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (want[1] >= 0).any() and int(want[2]) > int(active.sum())
    want = any_hit_packed(a, k, o, d, smax, active, fmt=leaf_fmt)
    got = any_hit_packed(b, k, o, d, smax, active, fmt=leaf_fmt)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert want[0].any() and not want[0][~active].any()


def _mesh_arrays():
    scene = create_cornell_box(mesh=None)
    v0, v1, v2 = icosphere_mesh(1, 15.0)
    off = np.array([50.0, 20.0, 50.0], np.float32)
    for a, b, c in zip(v0 + off, v1 + off, v2 + off):
        scene.objects.append(Object(v0=tuple(a), v1=tuple(b), v2=tuple(c),
                                    albedo=(0.75, 0.75, 0.75)))
    return flatten_scene(scene)


def test_bounce_renderer_walks_a_copy_of_its_table_also_after_refit():
    arrays = _mesh_arrays()
    r = Renderer(arrays, cfg=RenderConfig(width=W, height=H,
                                          engine="bounce"), device="cpu")
    sc = r.scene

    def copy_of(scene):
        rows, _ = threaded_walk_order_table(
            scene.node_table.numpy(), scene.leaf_size, scene.leaf_fmt)
        return torch.from_numpy(rows)

    rows = copy_of(sc)
    assert torch.equal(r.inline, rows)
    seen = []
    real = wavefront.closest_hit

    def closest(table, *args, **kwargs):
        seen.append(table)
        return real(table, *args, **kwargs)

    params = CameraController().get_params(W, H)
    wavefront.closest_hit = closest
    try:
        r.step(params)
        moved = _mesh_arrays()
        off = np.array([40.0, 30.0, 50.0], np.float32)
        v0, v1, v2 = icosphere_mesh(1, 15.0)
        for name, v in (("tri_v0", v0), ("tri_v1", v1), ("tri_v2", v2)):
            getattr(moved, name)[-len(v):] = v + off
        r.refit(moved)
        r.step(params)
    finally:
        wavefront.closest_hit = real
    assert not torch.equal(r.scene.node_table, sc.node_table)
    rows2 = copy_of(r.scene)
    assert torch.equal(r.inline, rows2) and not torch.equal(rows2, rows)
    assert seen[0] is not seen[-1]
    assert torch.equal(seen[0], rows) and torch.equal(seen[-1], rows2)


# -- the kernel on a card ----------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA threaded walk runs only on a CUDA device")


@pytest.mark.cuda
def test_cuda_threaded_walk_refuses_unpadded_tables():
    _cuda()
    src, _, k = _scene(9, 200, "sah", "mt", 6)
    assert src.shape[1] % 4
    o, d, smax, _ = _rays(10)
    active = torch.ones(N, dtype=torch.bool)
    card = [x.cuda() for x in (torch.from_numpy(src), o, d, active)]
    with pytest.raises(ValueError, match="16-byte rows"):
        threaded.threaded_walk_cuda(card[0], k, *card[1:], fmt="mt")
    copy, _ = threaded_walk_order_table(src, k, "mt")
    flat = torch.zeros(copy.size + 1, device="cuda")
    shifted = flat[1:].view(copy.shape)
    shifted.copy_(torch.from_numpy(copy))
    with pytest.raises(ValueError, match="aligned"):
        threaded.threaded_walk_cuda(shifted, k, *card[1:], fmt="mt")


@pytest.mark.cuda
def test_cuda_bounce_launches_two_walks_and_no_fills_for_their_outputs():
    """One bounce on the card: the threaded walk twice, and each walk's
    wrapper launches its kernel and one zero fill (its two counters),
    nothing that fills an output."""
    _cuda()
    from torch.profiler import ProfilerActivity, profile

    r = Renderer(_mesh_arrays(), cfg=RenderConfig(width=64, height=48,
                                                  engine="bounce"))
    params = CameraController().get_params(64, 48)
    r.step(params)
    torch.cuda.synchronize()
    kernels = []
    real_c, real_a = wavefront.closest_hit, wavefront.any_hit

    def traced(real):
        def walk(*args, **kwargs):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = real(*args, **kwargs)
                torch.cuda.synchronize()
            kernels.append(sorted(e.name for e in prof.events()
                                  if e.device_type.name == "CUDA"))
            return out
        return walk

    wavefront.closest_hit = traced(real_c)
    wavefront.any_hit = traced(real_a)
    before = threaded.threaded_walk_cuda.launches
    try:
        scene, tables = r.scene, r.bounce_tables
        n = 64 * 48
        pixels = torch.arange(n, device=scene.trimat.device)
        bp = bounce.bounce_params(scene, tables, r.cfg, 64, 48, params)
        s = bounce.bounce_rays(bp, 1, pixels)
        s.update(bounce.new_nee_state(n, pixels.device))
        wavefront._bounce(scene, r.inline, tables, bp, 1, pixels, 0, s,
                          torch.zeros(2, dtype=torch.int64,
                                      device=pixels.device))
    finally:
        wavefront.closest_hit, wavefront.any_hit = real_c, real_a
    assert threaded.threaded_walk_cuda.launches == before + 2
    assert len(kernels) == 2
    for names in kernels:
        walks = [x for x in names if "threaded_walk_kernel" in x]
        others = [x for x in names if "threaded_walk_kernel" not in x]
        assert len(walks) == 1 and len(others) == 1, names
        assert any(w in others[0].lower() for w in ("fill", "memset")), names

"""The port's bounce engine (engine/wavefront.py) and its threaded walks
(ops/traverse.py closest_hit_packed / any_hit_packed, the plain versions
of csrc/threaded_walk.cu), on the CPU, held against the JAX package.

Tolerances:
  - the threaded table and its links: byte for byte (the same NumPy);
  - the walks: equal prim ids and occlusion; hit distances bit-equal to
    the JAX intersection of the hit triangle evaluated op by op, and
    within rtol 1e-5 of the jitted JAX walk, whose arithmetic XLA:CPU
    fuses (the rule of tests/test_torch_ops.py);
  - the texture sampler: bit-equal where both evaluate op by op;
  - renders against the JAX bounce Renderer: XLA:CPU fuses its walks'
    and its shading's arithmetic, which moves some sums past the JAX
    engine test's ``_ULP`` (rtol 2e-6, atol 1e-6;
    tests/test_persistent_engine.py).  Measured at 16x12, spp 2: 474 of
    576 sum floats differ, 6 of them past ``_ULP``; the largest
    differences are 6.1e-6 absolute and 1.9e-5 relative, the MSE of
    the means 3.5e-14.  So the port is held to the JAX Renderer within
    atol ``ATOL_JAX`` (about 3x the largest measured difference) and by
    its bound against a JAX Renderer, MSE < 1e-9
    (tests/test_torch_renderer.py), with equal ray counts;
  - the port's bounce engine against its persistent engine: the same
    per-lane arithmetic over other trees, so equal ray counts and sums
    within ``_ULP``;
  - against the NumPy oracle: MSE < 1e-9 (tests/test_golden.py).
One JAX engine program is compiled (the 16x12 bounce step and its ray
stats); the rest is eager.  The ``cuda`` cases hold the kernel to its
plain version on a card and skip elsewhere."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tryraytrace_tpu.accel import bvh as jbvh
from tryraytrace_tpu.engine import device_scene as jdevice_scene
from tryraytrace_tpu.ops import texture as jtex
from tryraytrace_tpu.ops import traverse as jtrav
from tryraytrace_tpu.ops.intersect import baldwin_intersect as jbaldwin
from tryraytrace_tpu.ops.intersect import baldwin_rows
from tryraytrace_tpu.ops.intersect import moller_trumbore_pre as jmt

from tryraytrace_tpu_torch.accel import bvh as tbvh
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import device_scene as tdevice_scene
from tryraytrace_tpu_torch.engine import wavefront
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import bounce
from tryraytrace_tpu_torch.ops import texture as ttex
from tryraytrace_tpu_torch.ops import threaded
from tryraytrace_tpu_torch.ops import traverse as ttrav
from tryraytrace_tpu_torch.oracle import oracle_render
from tryraytrace_tpu_torch.scene import objloader
from tryraytrace_tpu_torch.scene.assets import checker_texture, icosphere_mesh
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, flatten_scene

torch.set_num_threads(1)

N = 2048
W, H = 16, 12
MSE_EXPECT = 1e-9                  # tests/test_golden.py
ULP = dict(rtol=2e-6, atol=1e-6)   # tests/test_persistent_engine.py _ULP
ATOL_JAX = 2e-5                    # the JAX bounce Renderer's sums
RTOL_FUSED = 1e-5                  # tests/test_torch_ops.py


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_tris(n, seed, stretch=1.0):
    r = np.random.RandomState(seed)
    base = r.uniform(-5, 5, size=(n, 1, 3)).astype(np.float32)
    tri = base + r.uniform(-0.8, 0.8, size=(n, 3, 3)).astype(np.float32)
    tri[::7, :, 0] *= stretch
    return tri[:, 0].copy(), tri[:, 1].copy(), tri[:, 2].copy()


def _mesh_scene(jax_package=False, **material):
    """Cornell box + a 80-triangle icosphere of ``material``, built by the
    port's scene modules or the JAX package's (the same arrays)."""
    if jax_package:
        from tryraytrace_tpu.scene import assets, cornell, model
    else:
        from tryraytrace_tpu_torch.scene import assets, cornell, model
    scene = cornell.create_cornell_box(mesh=None)
    v0, v1, v2 = assets.icosphere_mesh(1, 15.0)
    for a, b, c in zip(v0 + [50, 25, 50], v1 + [50, 25, 50],
                       v2 + [50, 25, 50]):
        scene.objects.append(model.Object(v0=tuple(a), v1=tuple(b),
                                          v2=tuple(c), **material))
    return model.flatten_scene(scene, textures=[assets.checker_texture(32)])


# -- the threaded table ---------------------------------------------------

@pytest.mark.parametrize("method,leaf_fmt,leaf_size", [
    ("sah", "bw", 4), ("sah", "mt", 6), ("sbvh", "bw", 4),
    ("sbvh", "mt", 8), ("median", "mt", 1)])
def test_pack_traversal_table_matches_jax(method, leaf_fmt, leaf_size):
    v0, v1, v2 = _random_tris(160, seed=11, stretch=4.0)
    bvh = tbvh.build_bvh(v0, v1, v2, method=method, leaf_size=leaf_size)
    jb = jbvh.build_bvh(v0, v1, v2, method=method, leaf_size=leaf_size)
    for o in range(8):
        for a, b in zip(tbvh.thread_octant(bvh, o), jbvh.thread_octant(jb, o)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    p = bvh.perm
    ours = tbvh.pack_traversal_table(bvh, v0[p], v1[p], v2[p],
                                     leaf_size=leaf_size, leaf_fmt=leaf_fmt)
    theirs = jbvh.pack_traversal_table(jb, v0[p], v1[p], v2[p],
                                       leaf_size=leaf_size,
                                       leaf_fmt=leaf_fmt)
    assert ours.shape == (bvh.num_nodes,
                          tbvh.traversal_row_width(leaf_size, leaf_fmt))
    assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()


def test_upload_node_table_and_refit_match_jax():
    arrays = _mesh_scene(albedo=(0.7, 0.6, 0.2))
    tdev, _, bvh = tdevice_scene.upload_scene(arrays, device="cpu",
                                              leaf_fmt="mt")
    jdev, _, jb = jdevice_scene.upload_scene(
        arrays, device_put=False, leaf_size=0, leaf_fmt="mt",
        quad_collapse="dp", quad_layout="mux")
    assert tdev.node_table.numpy().tobytes() == np.asarray(
        jdev.node_table).tobytes()
    moved = dataclasses.replace(arrays)
    rs = np.random.RandomState(2)
    for name in ("tri_v0", "tri_v1", "tri_v2"):
        v = getattr(arrays, name).copy()
        v[7:] += rs.normal(0, 0.5, size=v[7:].shape).astype(np.float32)
        setattr(moved, name, v)
    tnew, _ = tdevice_scene.refit_scene(tdev, bvh, moved)
    jnew, _ = jdevice_scene.refit_scene(jdev, jb, moved, device_put=False)
    got = tnew.node_table.numpy()
    assert got.tobytes() == np.asarray(jnew.node_table).tobytes()
    assert got.tobytes() != tdev.node_table.numpy().tobytes()


# -- the walks -------------------------------------------------------------

def _walk_scene(seed, n_tris, leaf_fmt, leaf_size=4):
    v0, v1, v2 = _random_tris(n_tris, seed)
    bvh = jbvh.build_bvh(v0, v1, v2, method="sah", leaf_size=leaf_size)
    tris = tuple(v[bvh.perm] for v in (v0, v1, v2))
    table = jbvh.pack_traversal_table(bvh, *tris, leaf_size=leaf_size,
                                      leaf_fmt=leaf_fmt)
    r = np.random.RandomState(seed + 1)
    o = r.uniform(-8, 8, size=(N, 3)).astype(np.float32)
    d = r.uniform(-4, 4, size=(N, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:16, 1] = 0.0       # the safe inverse and the plain 1/d of zero
    return table, tris, o, d


def _t_unfused(tris, ids, o, d, leaf_fmt):
    """The JAX intersection of each lane's hit triangle, op by op."""
    v0, v1, v2 = (v[ids] for v in tris)
    if leaf_fmt == "bw":
        t = jbaldwin(jnp.asarray(baldwin_rows(v0, v1, v2)), jnp.asarray(o),
                     jnp.asarray(d))
    else:
        t = jmt(*map(jnp.asarray, (v0, v1 - v0, v2 - v0, o, d)))
    return np.asarray(t)


@pytest.mark.parametrize("leaf_fmt", ["bw", "mt"])
def test_closest_hit_packed_matches_jax(leaf_fmt):
    table, tris, o, d = _walk_scene(5, 600, leaf_fmt)
    active = np.ones(N, bool)
    active[::50] = False
    jt, jid = jax.jit(jtrav.closest_hit_packed, static_argnames=("k", "fmt"))(
        jnp.asarray(table), k=4, r_o=jnp.asarray(o), r_d=jnp.asarray(d),
        active=jnp.asarray(active), fmt=leaf_fmt)
    tt, tid, rows = ttrav.closest_hit_packed(_t(table), 4, _t(o), _t(d),
                                             _t(active), fmt=leaf_fmt)
    jt, jid, tt, tid = (np.asarray(jt), np.asarray(jid), tt.numpy(),
                        tid.numpy())
    np.testing.assert_array_equal(tid, jid)
    assert (tid[~active] == -1).all() and 0.3 < (tid >= 0).mean() < 1.0
    hit = tid >= 0
    np.testing.assert_array_equal(
        tt[hit], _t_unfused(tris, tid[hit], o[hit], d[hit], leaf_fmt))
    np.testing.assert_array_equal(tt[~hit], jt[~hit])
    np.testing.assert_allclose(tt, jt, rtol=RTOL_FUSED)
    assert int(rows) > N


@pytest.mark.parametrize("leaf_fmt", ["bw", "mt"])
def test_any_hit_packed_matches_jax(leaf_fmt):
    table, _, o, d = _walk_scene(6, 400, leaf_fmt)
    max_dist = np.random.RandomState(7).uniform(0.5, 12, N).astype(
        np.float32)
    active = np.ones(N, bool)
    active[::97] = False
    want = jax.jit(jtrav.any_hit_packed, static_argnames=("k", "fmt"))(
        jnp.asarray(table), k=4, r_o=jnp.asarray(o), r_d=jnp.asarray(d),
        max_dist=jnp.asarray(max_dist), active=jnp.asarray(active),
        fmt=leaf_fmt)
    got, rows = ttrav.any_hit_packed(_t(table), 4, _t(o), _t(d),
                                     _t(max_dist), _t(active), fmt=leaf_fmt)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert int(rows) > 0
    assert 0.1 < got.numpy().mean() < 0.9


def test_walks_match_brute_force():
    """Closest hit = the nearest triangle of all (ids at exact ties may
    differ), any hit = some triangle inside the window."""
    table, tris, o, d = _walk_scene(8, 300, "bw")
    active = torch.ones(N, dtype=torch.bool)
    tt, tid, _ = ttrav.closest_hit_packed(_t(table), 4, _t(o), _t(d),
                                          active, fmt="bw")
    bw = baldwin_rows(*tris)
    t_all = np.asarray(jbaldwin(bw[None], o[:, None], d[:, None], np))
    t_all = np.where(t_all > 0, t_all, np.float32(np.inf))
    best = t_all.min(axis=1)
    hit = np.isfinite(best)
    np.testing.assert_array_equal(tid.numpy() >= 0, hit)
    np.testing.assert_array_equal(tt.numpy()[hit], best[hit])
    smax = np.full(N, 6.0, np.float32)
    occ, _ = ttrav.any_hit_packed(_t(table), 4, _t(o), _t(d), _t(smax),
                                  active, fmt="bw")
    want = ((t_all > 1e-3) & (t_all < smax[:, None] - np.float32(1e-3))
            ).any(axis=1)
    np.testing.assert_array_equal(occ.numpy(), want)


def test_dispatch_takes_the_plain_version_on_the_cpu(monkeypatch):
    table, _, o, d = _walk_scene(9, 50, "mt")
    active = torch.ones(N, dtype=torch.bool)
    before = threaded.threaded_walk_cuda.launches
    t, hid, rows = threaded.closest_hit(_t(table), 4, _t(o), _t(d), active,
                                        fmt="mt")
    want = ttrav.closest_hit_packed(_t(table), 4, _t(o), _t(d), active,
                                    fmt="mt")
    assert all(torch.equal(a, b) for a, b in zip((t, hid, rows), want))
    assert threaded.threaded_walk_cuda.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        threaded.threaded_walk_cuda(_t(table), 4, _t(o), _t(d), active,
                                    fmt="mt")


# -- the texture sampler -----------------------------------------------------

def test_sample_textures_matches_jax():
    r = np.random.RandomState(3)
    texs = [r.uniform(0, 1, (37, 53, 3)).astype(np.float32),
            r.uniform(0, 1, (16, 16, 3)).astype(np.float32)]
    u = r.uniform(-3, 3, N).astype(np.float32)
    v = r.uniform(-3, 3, N).astype(np.float32)
    tex_id = r.randint(-1, 3, N).astype(np.int32)
    want = jtex.sample_textures(tuple(map(jnp.asarray, texs)),
                                jnp.asarray(tex_id), jnp.asarray(u),
                                jnp.asarray(v))
    got = ttex.sample_textures(tuple(map(_t, texs)),
                               _t(tex_id.astype(np.int64)), _t(u), _t(v))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got.numpy()[tex_id == 2] == 1.0).all()
    # The raw sampler equals the persistent engine's tile rows.
    rows, metas, _ = ttex.build_texture_tiles(texs)
    trow, offx, offy, fx, fy = ttex.tile_coords(
        metas, _t(tex_id.astype(np.int64)), _t(u), _t(v))
    tiled = ttex.tile_bilinear(_t(rows)[trow], offx, offy, fx, fy)
    sel = torch.from_numpy((tex_id >= 0) & (tex_id < 2))
    assert torch.equal(tiled[sel], got[sel])


# -- the bounce engine -------------------------------------------------------

def _step(arrays, cfg, aperture=0.0, frame=1, device="cpu"):
    r = Renderer(arrays, cfg=cfg, device=device)
    cam = CameraController()
    cam.aperture = aperture
    r.frame = frame
    r.step(cam.get_params(cfg.width, cfg.height))
    return r


def test_bounce_renderer_matches_jax_and_its_ray_counts():
    from tryraytrace_tpu.camera.controller import CameraController as JCam
    from tryraytrace_tpu.config import RenderConfig as JConfig
    from tryraytrace_tpu.engine.renderer import Renderer as JRenderer
    from tryraytrace_tpu.engine.wavefront import frame_ray_stats

    material = dict(albedo=(0.7, 0.6, 0.2), metallic=1.0, roughness=0.1)
    arrays = _mesh_scene(**material)
    jcfg = JConfig(width=W, height=H, spp=2, engine="bounce")
    jr = JRenderer(_mesh_scene(jax_package=True, **material), cfg=jcfg)
    jparams = JCam().get_params(W, H)
    jr.step(jparams)
    jitted = jr.accum_host().reshape(-1, 3)
    tr, sh = jax.jit(frame_ray_stats,
                     static_argnames=("width", "height", "cfg", "spp"))(
        jr.scene, jr.textures, jparams, jnp.uint32(1), width=W, height=H,
        cfg=jcfg, spp=2)

    r = _step(arrays, RenderConfig(width=W, height=H, spp=2,
                                   engine="bounce"))
    got = r.accum_host().reshape(-1, 3)
    assert float(((got / 2 - jitted / 2) ** 2).mean()) < MSE_EXPECT
    np.testing.assert_allclose(got, jitted, rtol=0, atol=ATOL_JAX)
    st = r.last_stats
    assert st["n_traced"].dtype == torch.int64
    assert (int(st["n_traced"]), int(st["n_shadow"])) == (int(tr), int(sh))
    assert int(tr) > W * H * 2 and int(sh) > 0
    assert torch.equal(r.inline, threaded.walk_table(
        r.scene.node_table, r.scene.leaf_size, r.scene.leaf_fmt))
    assert len(r.device_textures) == 1
    assert wavefront.frame_ray_stats(
        r.scene, r.inline, r.device_textures,
        CameraController().get_params(W, H).to("cpu"), 1, W, H, r.cfg,
        2) == (int(tr), int(sh))


@pytest.mark.parametrize("aperture", [0.0, 1.0])
@pytest.mark.parametrize("leaf_fmt", ["bw", "mt"])
def test_bounce_equals_persistent(aperture, leaf_fmt):
    arrays = _mesh_scene(albedo=(0.75, 0.75, 0.75), metallic=1.0,
                         roughness=0.1)
    out = {}
    for engine in ("persistent", "bounce"):
        r = _step(arrays, RenderConfig(width=W, height=H, spp=2,
                                       engine=engine, leaf_isect=leaf_fmt),
                  aperture=aperture)
        out[engine] = (r.accum_host(), int(r.last_stats["n_traced"]),
                       int(r.last_stats["n_shadow"]))
    (a, *ca), (b, *cb) = out["persistent"], out["bounce"]
    assert ca == cb
    np.testing.assert_allclose(b, a, **ULP)
    assert b.mean() > 0


def _two_light_scene():
    """tests/test_golden.py's: the box's ceiling light and a warm panel
    of two emitters on the back wall."""
    scene = create_cornell_box(mesh=None)
    for tri in (((20, 40, 598), (40, 40, 598), (40, 60, 598)),
                ((20, 40, 598), (40, 60, 598), (20, 60, 598))):
        scene.objects.append(Object(v0=tri[0], v1=tri[1], v2=tri[2],
                                    albedo=(0, 0, 0),
                                    emission=(8.0, 4.0, 1.0),
                                    roughness=1.0))
    return flatten_scene(scene, textures=[checker_texture(32)])


def _uv_sphere_scene(tmp_path):
    """A UV sphere from an .obj (loader normals, texture slot 0)."""
    tris = np.stack(icosphere_mesh(1), axis=1)
    verts, faces = np.unique(tris.reshape(-1, 3), axis=0,
                             return_inverse=True)
    faces = faces.reshape(-1, 3) + 1
    u = 0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi)
    v = 0.5 - np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi
    path = tmp_path / "sphere.obj"
    with open(path, "w") as f:
        for p in verts.astype(np.float64).tolist():
            f.write(f"v {p[0]!r} {p[1]!r} {p[2]!r}\n")
        for a, b in zip(u, v):
            f.write(f"vt {float(a)!r} {float(b)!r}\n")
        for a, b, c in faces:
            f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
    scene = create_cornell_box(mesh=None)
    objloader.load_obj(str(path), scene.objects, offset=(50.0, 25.0, 60.0),
                       scale=20.0, parse_uv=True, tex_id=0)
    return flatten_scene(scene, textures=[checker_texture(32)])


@pytest.mark.parametrize("case", ["two-lights", "mesh", "smooth", "uv",
                                  "all"])
def test_bounce_matches_the_oracle(case, tmp_path):
    kw = dict(spp=2, engine="bounce")
    if case == "two-lights":
        arrays = _two_light_scene()
    elif case == "mesh":
        arrays = _mesh_scene(albedo=(0.7, 0.6, 0.2), metallic=1.0,
                             roughness=0.1)
    else:
        arrays = _uv_sphere_scene(tmp_path)
        kw.update(dict(smooth=dict(smooth_shading=True),
                       uv=dict(uv_mapping=True),
                       all=dict(smooth_shading=True, uv_mapping=True,
                                leaf_isect="mt", bvh_method="sbvh"))[case])
    cfg = RenderConfig(width=W, height=H, **kw)
    r = _step(arrays, cfg)
    got = r.accum_host().reshape(-1, 3) / 2
    want = oracle_render(arrays, CameraController().get_params(W, H), W, H,
                         frame_seed=1, spp=2, cfg=cfg).reshape(-1, 3) / 2
    assert np.isfinite(got).all() and got.mean() > 0
    assert float(((got - want) ** 2).mean()) < MSE_EXPECT


def test_bounce_tiles_refit_and_spp_guard():
    """step_tiled equals step; a refit repacks the threaded table and
    then renders what a fresh build of the moved scene renders; the
    spp guard holds."""
    arrays = _mesh_scene(albedo=(0.75, 0.75, 0.75))
    cfg = RenderConfig(width=W, height=H, engine="bounce")
    params = CameraController().get_params(W, H)
    r = Renderer(arrays, cfg=cfg, device="cpu")
    r.step(params)
    tiled = Renderer(arrays, cfg=cfg, device="cpu")
    tiled.step_tiled(params, 3)
    assert torch.equal(r.state.accum, tiled.state.accum)
    assert int(r.last_stats["n_traced"]) == int(tiled.last_stats["n_traced"])
    with pytest.raises(ValueError, match="spp changed"):
        r.step(params, spp=2)

    moved = dataclasses.replace(arrays)
    rs = np.random.RandomState(5)
    for name in ("tri_v0", "tri_v1", "tri_v2"):
        v = getattr(arrays, name).copy()
        v[7:] += rs.normal(0, 1.0, size=v[7:].shape).astype(np.float32)
        setattr(moved, name, v)
    old = r.scene.node_table.clone()
    r.refit(moved)
    assert not torch.equal(r.scene.node_table, old)
    r.step(params)
    fresh = Renderer(moved, cfg=cfg, device="cpu")
    fresh.step(params)
    assert float(((r.accum_host() - fresh.accum_host()) ** 2).mean()) \
        < MSE_EXPECT
    assert int(r.last_stats["n_traced"]) == int(fresh.last_stats["n_traced"])


def test_sample_offset_renders_a_slice_of_the_sample_set():
    """Samples [2, 4) of a 4-spp schedule, rendered with offset 2, plus
    samples [0, 2) make the 4-spp frame, in both engines."""
    arrays = _mesh_scene(albedo=(0.75, 0.75, 0.75))
    params = CameraController().get_params(W, H)
    for engine in ("persistent", "bounce"):
        cfg = RenderConfig(width=W, height=H, engine=engine)
        r = Renderer(arrays, cfg=cfg, device="cpu")
        full, st = wavefront.render_frame(r.scene, r.inline,
                                          r.device_textures, params, 1, W,
                                          H, cfg, spp=4)
        parts = [wavefront.render_frame(r.scene, r.inline, r.device_textures,
                                        params, 1, W, H, cfg, spp=2,
                                        sample_offset=off, seed_spp=4)
                 for off in (0, 2)]
        np.testing.assert_allclose((parts[0][0] + parts[1][0]).numpy(),
                                   full.numpy(), **ULP)
        assert sum(int(p[1]["n_traced"]) for p in parts) == int(
            st["n_traced"])


# -- the kernel on a card ----------------------------------------------------

def _card_inputs(leaf_fmt, shadow, active_share):
    """The kernel's inputs over the walk-order copy (rows of 72 floats
    for "bw", 78 padded to 80 for "mt"), and the original table."""
    table, _, o, d = _walk_scene(12, 2000, leaf_fmt, leaf_size=6)
    copy, _ = tbvh.threaded_walk_order_table(table, 6, leaf_fmt)
    active = np.ones(N, bool)
    active[::31] = False
    active &= np.random.RandomState(14).rand(N) < active_share
    smax = np.random.RandomState(13).uniform(0.5, 12, N).astype(np.float32)
    args = [_t(copy), 6, _t(o), _t(d), _t(active)]
    if shadow:
        args.append(_t(smax))
    return args, _t(table)


@pytest.mark.cuda
@pytest.mark.parametrize("active_share", [1.0, 0.1])
@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("leaf_fmt", ["bw", "mt"])
def test_cuda_threaded_walk_matches_plain_version(leaf_fmt, shadow,
                                                  active_share):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA threaded walk runs only on a CUDA device")
    args, table = _card_inputs(leaf_fmt, shadow, active_share)
    card = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
    before = threaded.threaded_walk_cuda.launches
    got = threaded.threaded_walk_cuda(*card, fmt=leaf_fmt)
    torch.cuda.synchronize()
    assert threaded.threaded_walk_cuda.launches == before + 1
    for rows in (card[0], table.cuda()):
        if shadow:
            _, k, o, d, active, smax = card
            want = ttrav.any_hit_packed(rows, k, o, d, smax, active,
                                        fmt=leaf_fmt)
        else:
            want = ttrav.closest_hit_packed(rows, *card[1:], fmt=leaf_fmt)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_bounce_render_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA threaded walk runs only on a CUDA device")
    arrays = _mesh_scene(albedo=(0.75, 0.75, 0.75), metallic=1.0,
                         roughness=0.1)
    cfg = RenderConfig(width=64, height=48, spp=2, engine="bounce")
    before = threaded.threaded_walk_cuda.launches
    kernels = (bounce.bounce_rays_cuda, bounce.bounce_shade_cuda,
               bounce.bounce_nee_cuda)
    launched = [k.launches for k in kernels]
    card = _step(arrays, cfg, device="cuda")
    assert threaded.threaded_walk_cuda.launches > before
    # A sample's camera rays; a bounce's shade and NEE add (one light).
    bounces = card.last_stats["iterations"]
    assert [k.launches - n for k, n in zip(kernels, launched)] == [
        2, bounces, bounces]
    assert threaded.threaded_walk_cuda.launches == before + 2 * bounces
    cpu = _step(arrays, cfg)
    assert card.accum_host().tobytes() == cpu.accum_host().tobytes()
    assert ({k: int(v) for k, v in card.last_stats.items()}
            == {k: int(v) for k, v in cpu.last_stats.items()})

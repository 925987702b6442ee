"""The scene features past the port's default path, on the CPU: smooth
shading, UV mapping (the UV-aware OBJ parser), Moller-Trumbore leaf
rows, the SBVH build, BVH refit, any light count and textures past the
JAX engine's 2 MB tile budget.

The port is held against the JAX package's host functions (NumPy), its
ops through ``xp=np`` and its NumPy oracle: byte for byte where the
same NumPy runs, MSE < 1e-9 (tests/test_golden.py) for renders.  No
JAX engine program is compiled."""

import dataclasses

import numpy as np
import pytest
import torch

from tryraytrace_tpu.accel import bvh as jbvh
from tryraytrace_tpu.engine import device_scene as jdevice_scene
from tryraytrace_tpu.ops.intersect import moller_trumbore_pre as jmt
from tryraytrace_tpu.ops.shade import smooth_normal as jsmooth
from tryraytrace_tpu.ops.texture import interp_uv as jinterp_uv
from tryraytrace_tpu.oracle.cpu_renderer import oracle_render as joracle
from tryraytrace_tpu.scene import objloader as jobj

from tryraytrace_tpu_torch import cli
from tryraytrace_tpu_torch.accel import bvh as tbvh
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import device_scene as tdevice_scene
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.io.ppm import load_ppm
from tryraytrace_tpu_torch.ops import walk
from tryraytrace_tpu_torch.ops.intersect import moller_trumbore_pre
from tryraytrace_tpu_torch.ops.shade import smooth_normal
from tryraytrace_tpu_torch.ops.texture import interp_uv
from tryraytrace_tpu_torch.oracle import oracle_render
from tryraytrace_tpu_torch.scene import objloader
from tryraytrace_tpu_torch.scene.assets import checker_texture, icosphere_mesh
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, flatten_scene

torch.set_num_threads(1)

W, H = 16, 12
MSE_EXPECT = 1e-9  # tests/test_golden.py
SPHERE = (20.0, (50.0, 25.0, 60.0))  # scale, offset of the UV sphere


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def write_uv_sphere(path, subdiv: int = 1) -> int:
    """icosphere_mesh(subdiv) as an .obj with shared vertices and one
    spherical ``vt`` per vertex (``f a/a b/b c/c``)."""
    tris = np.stack(icosphere_mesh(subdiv), axis=1)
    verts, faces = np.unique(tris.reshape(-1, 3), axis=0,
                             return_inverse=True)
    faces = faces.reshape(-1, 3) + 1
    u = 0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi)
    v = 0.5 - np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi
    with open(path, "w") as f:
        for p in verts.astype(np.float64).tolist():
            f.write(f"v {p[0]!r} {p[1]!r} {p[2]!r}\n")
        for a, b in zip(u, v):
            f.write(f"vt {float(a)!r} {float(b)!r}\n")
        for a, b, c in faces:
            f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
    return int(faces.shape[0])


@pytest.fixture(scope="module")
def sphere_obj(tmp_path_factory):
    path = tmp_path_factory.mktemp("obj") / "uv_sphere.obj"
    write_uv_sphere(path)
    return str(path)


def _uv_scene(obj_path, tex=None, lights: int = 0):
    """Cornell box + the UV sphere (vertex normals from the loader,
    texture slot 0), ``lights`` extra small emitters under the
    ceiling."""
    scene = create_cornell_box(mesh=None)
    scale, offset = SPHERE
    objloader.load_obj(obj_path, scene.objects, offset=offset, scale=scale,
                       parse_uv=True, tex_id=0)
    for i in range(lights):
        x = 10.0 + 4 * i
        scene.objects.append(Object(v0=(x, 99.0, 40), v1=(x + 2, 99.0, 40),
                                    v2=(x + 1, 99.0, 42),
                                    emission=(5.0, 5.0, 5.0)))
    return flatten_scene(scene, textures=[checker_texture(32)
                                          if tex is None else tex])


def _render(arrays, cfg, frame: int = 1):
    """The port's Renderer on the CPU, one step: (radiance [n, 3] of the
    frame, its stats)."""
    r = Renderer(arrays, cfg=cfg, device="cpu")
    params = CameraController().get_params(cfg.width, cfg.height)
    r.frame = frame
    r.step(params)
    return r.accum_host().reshape(-1, 3), r.last_stats, r


def _check_against_oracles(arrays, cfg, got, frame: int = 1):
    params = CameraController().get_params(cfg.width, cfg.height)
    theirs = joracle(arrays, params, cfg.width, cfg.height, frame_seed=frame,
                     cfg=cfg)
    ours = oracle_render(arrays, params, cfg.width, cfg.height,
                         frame_seed=frame, cfg=cfg)
    assert ours.tobytes() == theirs.tobytes()
    assert np.isfinite(got).all() and got.mean() > 0
    mse = float(((got - theirs) ** 2).mean())
    assert mse < MSE_EXPECT, mse


# -- the OBJ loader -----------------------------------------------------

OBJ_FACES = {
    "v/vt": "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n",
    "v/vt/vn": "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1\nf 1/4/1 3/3/1 4/2/1\n",
    "v//vn": "vn 0 0 1\nf 1//1 2//1 3//1\nf 1//1 3//1 4//1\n",
    "negative": "f -4/-4 -3/-3 -2/-2\nf 1/1 3/3 4/4\n",
    "missing vt": "f 1/1 2/2 3/9\nf 1 3 4\nf 1/1 2/2 9/1\n",
}


@pytest.mark.parametrize("kind", list(OBJ_FACES))
def test_uv_parser_and_loader_match_jax(kind, tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0.5\nv 0 1 0\n"
                    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n" + OBJ_FACES[kind])
    ours = objloader.parse_obj_arrays_uv(path)
    theirs = jobj.parse_obj_arrays_uv(path)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    t_objs, j_objs = [], []
    for parse_uv in (False, True):
        kw = dict(offset=(1.0, 2.0, 3.0), scale=2.5, parse_uv=parse_uv,
                  tex_id=0)
        n = objloader.load_obj(str(path), t_objs, **kw)
        assert n == jobj.load_obj(str(path), j_objs, **kw)
    assert len(t_objs) == len(j_objs)
    for a, b in zip(t_objs, j_objs):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for key in da:
            assert (np.asarray(da[key], np.float32).tobytes()
                    == np.asarray(db[key], np.float32).tobytes()), key
    if kind == "missing vt":
        assert ours[3].tolist()[0] == [-1, -1, -1]


# -- SBVH, refit and the "mt" leaf rows ---------------------------------

def _random_tris(n, seed=0, stretch=1.0):
    """tests/test_sbvh.py's random triangles, long thin ones included."""
    r = np.random.RandomState(seed)
    base = r.uniform(-10, 10, size=(n, 1, 3)).astype(np.float32)
    tri = base + r.uniform(-1, 1, size=(n, 3, 3)).astype(np.float32)
    tri[::7, :, 0] *= stretch
    return tri[:, 0].copy(), tri[:, 1].copy(), tri[:, 2].copy()


BVH_FIELDS = ("bounds", "leaf_prim", "leaf_count", "miss", "left", "right",
              "axis", "perm")


def _same_bvh(a, b):
    for f in BVH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("n", [1, 2, 9, 100, 150])
def test_sbvh_matches_jax_with_its_invariants(n):
    v0, v1, v2 = _random_tris(n, seed=n, stretch=4.0)
    bvh = tbvh.build_bvh(v0, v1, v2, method="sbvh", leaf_size=8)
    _same_bvh(bvh, jbvh.build_bvh(v0, v1, v2, method="sbvh", leaf_size=8))
    m, r = bvh.num_nodes, bvh.perm.shape[0]
    assert r >= n and sorted(set(bvh.perm.tolist())) == list(range(n))
    slots = []
    for node in np.nonzero(bvh.leaf_count > 0)[0]:
        s = int(bvh.leaf_prim[node])
        slots.extend(range(s, s + int(bvh.leaf_count[node])))
    assert sorted(slots) == list(range(r))
    assert (bvh.leaf_count <= 8).all()
    internal = np.nonzero(bvh.leaf_count == 0)[0]
    np.testing.assert_array_equal(bvh.left[internal], internal + 1)
    assert (bvh.miss > np.arange(m)).all() and (bvh.miss <= m).all()
    for i in internal:
        for c in (bvh.left[i], bvh.right[i]):
            assert (bvh.bounds[i, :3] <= bvh.bounds[c, :3] + 1e-6).all()
            assert (bvh.bounds[i, 3:] >= bvh.bounds[c, 3:] - 1e-6).all()


@pytest.mark.parametrize("method", ["sah", "sbvh"])
def test_refit_bvh_matches_jax(method):
    v0, v1, v2 = _random_tris(200, seed=3, stretch=3.0)
    bvh = tbvh.build_bvh(v0, v1, v2, method=method, leaf_size=4)
    jb = jbvh.build_bvh(v0, v1, v2, method=method, leaf_size=4)
    move = np.random.RandomState(4).normal(0, 0.3, (200, 3, 3))
    p = bvh.perm
    w0, w1, w2 = ((v + move[:, i].astype(np.float32))[p]
                  for i, v in enumerate((v0, v1, v2)))
    got = tbvh.refit_bvh(bvh, w0, w1, w2)
    _same_bvh(got, jbvh.refit_bvh(jb, w0, w1, w2))
    assert not np.array_equal(got.bounds, bvh.bounds)
    for f in BVH_FIELDS[1:]:
        assert np.array_equal(getattr(got, f), getattr(bvh, f))


@pytest.mark.parametrize("leaf_fmt,method", [("mt", "sah"), ("mt", "sbvh"),
                                             ("bw", "sbvh")])
def test_quad_table_and_upload_match_jax(leaf_fmt, method, sphere_obj):
    v0, v1, v2 = _random_tris(150, seed=7)
    bvh = tbvh.build_bvh(v0, v1, v2, method="sah", leaf_size=4)
    kids = tbvh.collapse_bvh(bvh, criterion="dp")
    p = bvh.perm
    ours = tbvh.pack_quad_table(bvh, v0[p], v1[p], v2[p], leaf_size=4,
                                children=kids, leaf_fmt=leaf_fmt)
    theirs = jbvh.pack_quad_table(bvh, v0[p], v1[p], v2[p], leaf_size=4,
                                  children=kids, leaf_fmt=leaf_fmt)
    assert ours.shape[1] == tbvh.quad_row_width(4, leaf_fmt)
    assert ours.tobytes() == theirs.tobytes()
    wt, _ = tbvh.walk_order_table(ours, 4, leaf_fmt)
    assert wt.shape[1] == {"mt": 48, "bw": 60}[leaf_fmt]

    arrays = _uv_scene(sphere_obj)
    tdev, ttex, _ = tdevice_scene.upload_scene(
        arrays, method=method, device="cpu", leaf_fmt=leaf_fmt)
    jdev, jtex, _ = jdevice_scene.upload_scene(
        arrays, device_put=False, leaf_size=0, method=method,
        leaf_fmt=leaf_fmt, quad_collapse="dp", quad_layout="mux")
    for name in ("quad_table", "trimat", "light_indices"):
        a = getattr(tdev, name).numpy()
        b = np.asarray(getattr(jdev, name)).astype(a.dtype)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    for name in ("leaf_size", "num_lights", "has_normals", "has_uvs",
                 "leaf_fmt"):
        assert getattr(tdev, name) == getattr(jdev, name), name
    assert tdev.has_normals and tdev.has_uvs
    assert [t.tobytes() for t in ttex] == [np.asarray(t).tobytes()
                                           for t in jtex]


def test_ops_match_jax_numpy():
    rs = np.random.RandomState(0)
    n = 4096
    f = lambda *s: rs.normal(size=s).astype(np.float32)  # noqa: E731
    v0, e1, e2, o, d = f(n, 3), f(n, 3), f(n, 3), f(n, 3), f(n, 3)
    # Half the rays aim at a point of their triangle (a hit or an edge
    # case), the others anywhere.
    d[::2] = (v0 + 0.4 * e1 + 0.4 * e2 - o)[::2]
    e1[::17] = 0.0                                   # pad slots: a miss
    t = moller_trumbore_pre(_t(v0), _t(e1), _t(e2), _t(o), _t(d)).numpy()
    want = jmt(v0, e1, e2, o, d, xp=np)
    assert t.tobytes() == want.astype(np.float32).tobytes()
    assert (t > 0).sum() > 100 and (t[::17] == 0).all()
    n0, n1, n2, x = f(n, 3), f(n, 3), f(n, 3), f(n, 3)
    geo = f(n, 3)
    geo /= np.linalg.norm(geo, axis=1, keepdims=True)
    v1, v2 = v0 + e1, v0 + e2
    sm = smooth_normal(*map(_t, (v0, v1, v2, n0, n1, n2, x, geo))).numpy()
    want = jsmooth(v0, v1, v2, n0, n1, n2, x, geo, xp=np)
    np.testing.assert_array_equal(sm, want)
    uv, b1, b2 = f(n, 6), f(n), f(n)
    got = [a.numpy() for a in interp_uv(_t(uv), _t(b1), _t(b2))]
    for a, b in zip(got, jinterp_uv(uv, b1, b2, xp=np)):
        np.testing.assert_array_equal(a, b)


def _walk_state(o, d, cur, mode, smax=None):
    n = o.shape[0]
    f = torch.zeros
    return dict(mode=_t(mode), cur=_t(cur),
                d_min=torch.full((n,), 1e20), hit_id=torch.full(
                    (n,), -1, dtype=torch.int64),
                o=_t(o), d=_t(d), so=_t(o), sd=_t(d),
                smax=_t(smax if smax is not None else np.full(n, 1e20,
                                                              np.float32)),
                rad=f((n, 3)), pend=torch.ones((n, 3)),
                cont_after_shadow=f((n,), dtype=torch.bool),
                reg_e=torch.full((n, 3), -1, dtype=torch.int64),
                reg_s=torch.full((n, 3), -1, dtype=torch.int64))


def test_walk_plain_mt_matches_brute_force():
    v0, v1, v2 = _random_tris(300, seed=11, stretch=5.0)
    bvh = tbvh.build_bvh(v0, v1, v2, method="sbvh", leaf_size=4)
    p = bvh.perm
    pv0, pv1, pv2 = v0[p], v1[p], v2[p]
    table = tbvh.pack_quad_table(bvh, pv0, pv1, pv2, leaf_size=4,
                                 children=tbvh.collapse_bvh(bvh, criterion="dp"),
                                 leaf_fmt="mt")
    wt, _ = tbvh.walk_order_table(table, 4, "mt")
    rs = np.random.RandomState(5)
    n = 512
    o = rs.uniform(-12, 12, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # Brute force over every reference slot: closest t, lowest slot of
    # the closest triangle (duplicates carry the same triangle).
    tt = moller_trumbore_pre(_t(pv0)[None], _t(pv1 - pv0)[None],
                             _t(pv2 - pv0)[None], _t(o)[:, None],
                             _t(d)[:, None]).numpy()
    tt = np.where(tt > 0, tt, np.inf)
    best = tt.min(axis=1)
    hit = np.isfinite(best)
    for tab in (table, wt):
        modes = np.zeros(n, np.int64)
        s = _walk_state(o, d, np.zeros(n, np.int64), modes)
        out, rows = walk.walk_plain(s, _t(tab), tab.shape[0], 4, 1, fmt="mt")
        got_t = out["d_min"].numpy()
        got_id = out["hit_id"].numpy()
        assert ((got_id >= 0) == hit).all()
        np.testing.assert_array_equal(got_t[hit], best[hit])
        assert (pv0[got_id[hit]] == pv0[tt[hit].argmin(axis=1)]).all()
        assert int(rows) > n
        # Any hit: a shadow segment to 0.9 of the hit is clear, past it
        # blocked (SHADOW = 1; the walk's window is (1e-3, smax - 1e-3)).
        for frac, blocked in ((0.9, False), (1.1, True)):
            smax = np.where(hit, best * frac, 1.0).astype(np.float32)
            s = _walk_state(o, d, np.zeros(n, np.int64),
                            np.where(hit, 1, 4).astype(np.int64), smax)
            out, _ = walk.walk_plain(s, _t(tab), tab.shape[0], 4, 1, fmt="mt")
            lit = out["rad"].numpy()[:, 0] > 0
            far = hit & (best * 0.1 > 2e-3)
            assert (lit[far] == (not blocked)).all()


# -- renders against the JAX oracle -------------------------------------

FEATURES = {
    "smooth": dict(smooth_shading=True),
    "uv": dict(uv_mapping=True),
    "mt": dict(leaf_isect="mt"),
    "sbvh": dict(bvh_method="sbvh"),
    "all": dict(smooth_shading=True, uv_mapping=True, leaf_isect="mt",
                bvh_method="sbvh"),
}


@pytest.mark.parametrize("feature", list(FEATURES))
def test_feature_render_matches_jax_oracle(feature, sphere_obj):
    arrays = _uv_scene(sphere_obj)
    cfg = RenderConfig(width=W, height=H, **FEATURES[feature])
    got, stats, r = _render(arrays, cfg)
    _check_against_oracles(arrays, cfg, got)
    if feature in ("mt", "all"):
        assert r.scene.leaf_fmt == "mt"
        assert r.inline.walk.shape[1] == -(-(10 + 9 * r.scene.leaf_size)
                                           // 4) * 4
    if feature == "sbvh":
        base, base_stats, _ = _render(arrays, RenderConfig(width=W,
                                                           height=H))
        np.testing.assert_array_equal(got, base)   # bit-identical to SAH
        assert int(stats["n_traced"]) == int(base_stats["n_traced"])


@pytest.mark.parametrize("lights", [15, 16])
def test_many_lights_render(lights, sphere_obj):
    """16 and 17 lights (the box's own and ``lights`` more): the JAX
    engine's inline pick and its tick path's gather, one rule here."""
    arrays = _uv_scene(sphere_obj, lights=lights)
    assert arrays.num_lights == lights + 1
    cfg = RenderConfig(width=W, height=H)
    got, _, _ = _render(arrays, cfg)
    _check_against_oracles(arrays, cfg, got)


def test_texture_past_the_tile_budget(sphere_obj):
    """A 512x512 texture tiles to 4.9 MB, past the JAX engine's 2 MB
    budget (its tick path then shades textured hits); the port tiles it
    all and gives the oracle's image."""
    tex = checker_texture(512)
    arrays = _uv_scene(sphere_obj, tex=tex)
    cfg = RenderConfig(width=W, height=H, uv_mapping=True)
    got, _, r = _render(arrays, cfg)
    tile_bytes = (r.inline.table.shape[0] - r.inline.tex0) * 75 * 4
    assert tile_bytes > 2 * 1024 * 1024
    _check_against_oracles(arrays, cfg, got)


def test_refit_matches_a_fresh_build_and_the_oracle(sphere_obj):
    arrays = _uv_scene(sphere_obj)
    cfg = RenderConfig(width=W, height=H, smooth_shading=True,
                       leaf_isect="mt")
    r = Renderer(arrays, cfg=cfg, device="cpu")
    params = CameraController().get_params(W, H)
    r.step(params)
    mesh = arrays.uv_mask > 0
    rs = np.random.RandomState(1)
    moved = dataclasses.replace(arrays)
    for name in ("tri_v0", "tri_v1", "tri_v2"):
        v = getattr(arrays, name).copy()
        v[mesh] += rs.normal(0, 1.5, size=(int(mesh.sum()), 3)).astype(
            np.float32)
        setattr(moved, name, v)
    old_table = r.inline.walk.clone()
    r.refit(moved)
    assert r.frame == 1 and r.spp() == 0
    assert r.inline.walk.shape == old_table.shape
    assert not torch.equal(r.inline.walk, old_table)
    r.step(params)
    got = r.accum_host().reshape(-1, 3)
    fresh, fresh_stats, _ = _render(moved, cfg)
    assert float(((got - fresh) ** 2).mean()) < MSE_EXPECT
    assert int(r.last_stats["n_traced"]) == int(fresh_stats["n_traced"])
    assert int(r.last_stats["n_shadow"]) == int(fresh_stats["n_shadow"])
    _check_against_oracles(moved, cfg, got)


def test_refit_with_another_topology_raises(sphere_obj):
    arrays = _uv_scene(sphere_obj)
    r = Renderer(arrays, cfg=RenderConfig(width=8, height=8), device="cpu")
    fewer = flatten_scene(create_cornell_box(mesh=None),
                          textures=[checker_texture(32)])
    with pytest.raises(ValueError, match="identical topology"):
        r.refit(fewer)


def test_cli_render_with_every_feature(sphere_obj, tmp_path, capsys):
    scale, (x, y, z) = SPHERE
    w, h = 32, 24
    argv = ["--scene", "cornell-nomesh", "--obj",
            f"{sphere_obj}:{scale}:{x},{y},{z}", "--width", str(w),
            "--height", str(h), "--device", "cpu", "--smooth", "--uv",
            "--leaf-isect", "mt", "--bvh-method", "sbvh"]
    out = tmp_path / "f.ppm"
    assert cli.main(["render", *argv, "--frames", "1", "--out",
                     str(out)]) == 0
    args = cli.build_parser().parse_args(["render", *argv])
    arrays = cli.build_scene_arrays(args)
    mesh = arrays.uv_mask > 0
    assert mesh.sum() == 80 and (arrays.tex_id[mesh] == 0).all()
    cfg = RenderConfig(width=w, height=h, smooth_shading=True,
                       uv_mapping=True, leaf_isect="mt", bvh_method="sbvh")
    r = Renderer(arrays, cfg=cfg, device="cpu")
    r.step(CameraController().get_params(w, h))
    assert load_ppm(str(out)).tobytes() == r.image().tobytes()

"""The port's tensor ops against the JAX package's functions on the same
seeded inputs.

Tolerance: rtol 1e-6 (float32 carries ~6e-8 relative per op).  The
outputs that pass through sin/cos/pow, whose float32 implementations
differ by an ulp between XLA and torch, also get atol 1e-6, since an
ulp of the argument near a zero of cos is larger than rtol of the
result there; the branch weights get atol 1e-5, because 1 - F cancels
as the Fresnel term F nears 1 and magnifies that ulp.  XLA:CPU fuses
the jitted quad walk's intersection arithmetic, so the walk's hit
distances are held bit-equal to the unfused JAX intersection of the
same triangle, and within rtol 1e-5 of the fused walk."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import tryraytrace_tpu.config as jconfig
from tryraytrace_tpu.accel.bvh import build_bvh as jbuild_bvh
from tryraytrace_tpu.accel.bvh import pack_quad_table as jpack_quad
from tryraytrace_tpu.camera.controller import CameraController as JCam
from tryraytrace_tpu.engine.camera_rays import generate_rays as jgen
from tryraytrace_tpu.engine.wavefront import _sanitize as jsanitize
from tryraytrace_tpu.ops import shade as jshade
from tryraytrace_tpu.ops import texture as jtex
from tryraytrace_tpu.ops.intersect import baldwin_intersect as jbaldwin
from tryraytrace_tpu.ops.intersect import baldwin_rows
from tryraytrace_tpu.ops.traverse import any_hit_quad as jany
from tryraytrace_tpu.ops.traverse import closest_hit_quad as jclosest

from tryraytrace_tpu_torch import config as tconfig
from tryraytrace_tpu_torch.camera.controller import CameraController as TCam
from tryraytrace_tpu_torch.engine.camera_rays import generate_rays as tgen
from tryraytrace_tpu_torch.engine.wavefront import _sanitize as tsanitize
from tryraytrace_tpu_torch.ops import shade as tshade
from tryraytrace_tpu_torch.ops import texture as ttex
from tryraytrace_tpu_torch.ops.intersect import baldwin_intersect as tbaldwin
from tryraytrace_tpu_torch.ops.traverse import any_hit_quad as tany
from tryraytrace_tpu_torch.ops.traverse import closest_hit_quad as tclosest

torch.set_num_threads(1)

N = 4096
RTOL = 1e-6
ATOL_TRIG = 1e-6
ATOL_WEIGHTS = 1e-5


def _close(want, got, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=atol)


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("aperture", [0.0, 2.0])
def test_generate_rays(aperture):
    w, h = 64, 48
    jc, tc = JCam(), TCam()
    jc.aperture = tc.aperture = aperture
    jp, tp = jc.get_params(w, h), tc.get_params(w, h).to("cpu")
    r = np.random.RandomState(0)
    pix = r.randint(0, w * h, size=N).astype(np.int32)
    seed = r.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    jo, jd = jgen(jp, w, h, jnp.asarray(seed), jnp.asarray(pix))
    to, td = tgen(tp, w, h, _t(seed.astype(np.int64)), _t(pix.astype(np.int64)))
    atol = ATOL_TRIG if aperture else 0.0
    _close(jo, to, atol)
    _close(jd, td, atol)


def test_baldwin_intersect():
    r = np.random.RandomState(1)
    v0 = r.uniform(-1, 1, (N, 3)).astype(np.float32)
    v1 = v0 + r.uniform(-1, 1, (N, 3)).astype(np.float32)
    v2 = v0 + r.uniform(-1, 1, (N, 3)).astype(np.float32)
    rows = baldwin_rows(v0, v1, v2)
    o = r.uniform(-3, 3, (N, 3)).astype(np.float32)
    tgt = (v0 + v1 + v2) / 3 + r.normal(scale=0.3, size=(N, 3)).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    want = np.asarray(jbaldwin(jnp.asarray(rows), jnp.asarray(o), jnp.asarray(d)))
    got = tbaldwin(_t(rows), _t(o), _t(d)).numpy()
    assert (want > 0).mean() > 0.2
    np.testing.assert_array_equal(want > 0, got > 0)
    _close(want, got)


def _shade_inputs(seed):
    r = np.random.RandomState(seed)
    return dict(
        albedo=r.uniform(0, 1, (N, 3)).astype(np.float32),
        metallic=r.uniform(0, 1, N).astype(np.float32),
        roughness=r.uniform(0, 1, N).astype(np.float32),
        transmission=(r.uniform(0, 1, N) > 0.5).astype(np.float32),
        ior=r.uniform(1.0, 2.0, N).astype(np.float32),
        n=_unit(r, N), d=_unit(r, N),
        u1=r.uniform(0, 1, N).astype(np.float32),
        u2=r.uniform(0, 1, N).astype(np.float32),
        v0=r.uniform(-5, 5, (N, 3)).astype(np.float32),
        v1=r.uniform(-5, 5, (N, 3)).astype(np.float32),
        v2=r.uniform(-5, 5, (N, 3)).astype(np.float32),
    )


def test_shade_ops():
    x = _shade_inputs(2)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: _t(v) for k, v in x.items()}
    nl_np = np.where(((x["n"] * x["d"]).sum(-1) < 0)[:, None], x["n"], -x["n"])
    j["nl"], t["nl"] = jnp.asarray(nl_np), _t(nl_np)

    for a, b in zip(jshade.pbr_weights(j["albedo"], j["metallic"],
                                       j["roughness"], j["transmission"],
                                       j["nl"], j["d"]),
                    tshade.pbr_weights(t["albedo"], t["metallic"],
                                       t["roughness"], t["transmission"],
                                       t["nl"], t["d"])):
        _close(a, b, ATOL_WEIGHTS)
    _close(jshade.reflect(j["d"], j["n"]), tshade.reflect(t["d"], t["n"]))
    _close(jshade.sample_unit_sphere(j["u1"], j["u2"]),
           tshade.sample_unit_sphere(t["u1"], t["u2"]), ATOL_TRIG)
    _close(jshade.rough_perturb(j["d"], j["roughness"], j["u1"], j["u2"]),
           tshade.rough_perturb(t["d"], t["roughness"], t["u1"], t["u2"]),
           ATOL_TRIG)
    jd, jtir = jshade.refract_branch(j["d"], j["n"], j["nl"], j["ior"],
                                     j["roughness"], j["u1"], j["u2"])
    td, ttir = tshade.refract_branch(t["d"], t["n"], t["nl"], t["ior"],
                                     t["roughness"], t["u1"], t["u2"])
    np.testing.assert_array_equal(np.asarray(jtir), ttir.numpy())
    _close(jd, td, ATOL_TRIG)
    _close(jshade.cosine_hemisphere(j["nl"], j["u1"], j["u2"]),
           tshade.cosine_hemisphere(t["nl"], t["u1"], t["u2"]), ATOL_TRIG)
    _close(jshade.triangle_area(j["v0"], j["v1"], j["v2"]),
           tshade.triangle_area(t["v0"], t["v1"], t["v2"]))
    _close(jshade.sample_triangle(j["v0"], j["v1"], j["v2"], j["u1"], j["u2"]),
           tshade.sample_triangle(t["v0"], t["v1"], t["v2"], t["u1"], t["u2"]))
    x_hit = (0.2 * x["v0"] + 0.3 * x["v1"] + 0.5 * x["v2"]).astype(np.float32)
    jb = jshade.barycentric(j["v0"], j["v1"], j["v2"], jnp.asarray(x_hit))
    tb = tshade.barycentric(t["v0"], t["v1"], t["v2"], _t(x_hit))
    np.testing.assert_array_equal(np.asarray(jb[2]), tb[2].numpy())
    _close(jb[0], tb[0], 1e-5)
    _close(jb[1], tb[1], 1e-5)
    # Vertex normals, a quarter of the triangles without any.
    r = np.random.RandomState(4)
    ns = [_unit(r, N) * (np.arange(N) % 4 > 0)[:, None].astype(np.float32)
          for _ in range(3)]
    geo = np.cross(x["v1"] - x["v0"], x["v2"] - x["v0"])
    geo = (geo / np.linalg.norm(geo, axis=1, keepdims=True)).astype(np.float32)
    _close(jshade.smooth_normal(j["v0"], j["v1"], j["v2"],
                                *map(jnp.asarray, ns), jnp.asarray(x_hit),
                                jnp.asarray(geo)),
           tshade.smooth_normal(t["v0"], t["v1"], t["v2"], *map(_t, ns),
                                _t(x_hit), _t(geo)), 1e-5)


def test_texture_ops():
    r = np.random.RandomState(3)
    texs = [r.uniform(0, 1, (37, 53, 3)).astype(np.float32),
            r.uniform(0, 1, (16, 16, 3)).astype(np.float32)]
    rows, metas, _ = ttex.build_texture_tiles(texs)
    jrows, jmetas, _ = jtex.build_texture_tiles(tuple(jnp.asarray(a) for a in texs))
    np.testing.assert_array_equal(np.asarray(jrows), rows)
    assert metas == jmetas

    x_hit = r.uniform(-300, 300, (N, 3)).astype(np.float32)
    nrm = _unit(r, N)
    tex_id = r.randint(-1, 3, N).astype(np.int32)
    ju, jv = jtex.planar_uv(jnp.asarray(x_hit), jnp.asarray(nrm), jnp.float32(0.01))
    tu, tv = ttex.planar_uv(_t(x_hit), _t(nrm), 0.01)
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())

    jc = jtex.tile_coords(texs, jmetas, jnp.asarray(tex_id), ju, jv)
    tc = ttex.tile_coords(metas, _t(tex_id.astype(np.int64)), tu, tv)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    trow, offx, offy, fx, fy = tc
    gathered = rows[trow.numpy()]
    jf = jtex.tile_bilinear(jnp.asarray(gathered), jc[1], jc[2], jc[3], jc[4])
    tf = ttex.tile_bilinear(_t(gathered), offx, offy, fx, fy)
    _close(jf, tf)
    # The tile path equals the 4-tap wrap sampler (the reference's).
    sel = tex_id == 0
    want = jtex.sample_bilinear_wrap(jnp.asarray(texs[0]), ju, jv)
    _close(np.asarray(want)[sel], tf.numpy()[sel])

    b1 = r.uniform(0, 0.5, N).astype(np.float32)
    b2 = r.uniform(0, 0.5, N).astype(np.float32)
    uvr = r.uniform(0, 1, (N, 6)).astype(np.float32)
    for a, b in zip(jtex.interp_uv(jnp.asarray(uvr), jnp.asarray(b1), jnp.asarray(b2)),
                    ttex.interp_uv(_t(uvr), _t(b1), _t(b2))):
        _close(a, b)


def test_sanitize():
    r = np.random.RandomState(4)
    rad = (r.normal(size=(N, 3)) * 80).astype(np.float32)
    rad[:32, 0] = np.nan
    rad[32:64, 1] = np.inf
    rad[64:96] = 300.0
    for clamp in (True, False):
        cfg_kw = dict(clamp_fireflies=clamp)
        want = jsanitize(jnp.asarray(rad), jconfig.RenderConfig(**cfg_kw))
        got = tsanitize(_t(rad), tconfig.RenderConfig(**cfg_kw))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _walk_scene(seed, n_tris):
    """Random triangles in [-5, 5]^3 and rays from [-8, 8]^3 aimed at
    random points among them."""
    r = np.random.RandomState(seed)
    base = r.uniform(-5, 5, size=(n_tris, 1, 3)).astype(np.float32)
    tri = base + r.uniform(-0.8, 0.8, size=(n_tris, 3, 3)).astype(np.float32)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    bvh = jbuild_bvh(v0, v1, v2, method="sah", leaf_size=8)
    pv0, pv1, pv2 = v0[bvh.perm], v1[bvh.perm], v2[bvh.perm]
    table = jpack_quad(bvh, pv0, pv1, pv2, leaf_size=8, leaf_fmt="bw",
                       collapse="dp")
    o = r.uniform(-8, 8, size=(N, 3)).astype(np.float32)
    d = r.uniform(-4, 4, size=(N, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return table, (pv0, pv1, pv2), o, d


def _brute_t(tris, o, d):
    """[rays, triangles] Baldwin-Weber distances (inf on a miss), op by
    op with NumPy."""
    bw = baldwin_rows(*tris)
    t = jbaldwin(bw[None], o[:, None], d[:, None], np)
    return np.where(t > 0, t, np.float32(np.inf))


def test_closest_hit_quad_matches_jax():
    table, tris, o, d = _walk_scene(5, 700)
    active = np.ones(N, bool)
    active[:64] = False
    jt, jid = jax.jit(jclosest, static_argnames=("k", "fmt"))(
        jnp.asarray(table), k=8, r_o=jnp.asarray(o), r_d=jnp.asarray(d),
        active=jnp.asarray(active), fmt="bw")
    tt, tid = tclosest(_t(table), 8, _t(o), _t(d), _t(active), fmt="bw")
    jt, jid, tt, tid = (np.asarray(jt), np.asarray(jid), tt.numpy(),
                        tid.numpy())
    assert (tid[:64] == -1).all() and (tid >= 0).mean() > 0.3
    bad = np.nonzero(tid != jid)[0]
    assert bad.size <= N * 1e-3
    if bad.size:
        t = _brute_t(tris, o[bad], d[bad])
        ties = (t == t.min(axis=1, keepdims=True)).sum(axis=1)
        assert (ties > 1).all(), bad
    # Distances: the JAX intersection of the hit triangle, unfused.
    hit = tid >= 0
    rows = baldwin_rows(*tris)[tid[hit]]
    want = np.asarray(jbaldwin(jnp.asarray(rows), jnp.asarray(o[hit]),
                               jnp.asarray(d[hit])))
    np.testing.assert_allclose(tt[hit], want, rtol=RTOL)
    np.testing.assert_array_equal(tt[~hit], jt[~hit])
    np.testing.assert_allclose(tt, jt, rtol=1e-5)


def test_any_hit_quad_matches_jax():
    table, tris, o, d = _walk_scene(6, 400)
    max_dist = np.random.RandomState(7).uniform(0.5, 12, N).astype(np.float32)
    active = np.ones(N, bool)
    active[::97] = False
    want = jax.jit(jany, static_argnames=("k", "fmt"))(
        jnp.asarray(table), k=8, r_o=jnp.asarray(o), r_d=jnp.asarray(d),
        max_dist=jnp.asarray(max_dist), active=jnp.asarray(active),
        fmt="bw")
    got = tany(_t(table), 8, _t(o), _t(d), _t(max_dist), _t(active),
               fmt="bw")
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert 0.1 < got.numpy().mean() < 0.9

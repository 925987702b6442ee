"""The persistent engine's service pass (ops/service.py).

  - its plain version, the eager block of engine/persistent.py
    (``service_plain``), against the JAX engine's ``_service_select``,
    row gather and ``_service_shade`` (which ends in ``_refill``;
    tryraytrace_tpu/engine/persistent.py:776,793,1450), run op by op on
    the CPU, on seed-made states that reach every branch: SHADEG hits
    and misses, emitters, specular, transmissive and diffuse bounces
    with NEE, textured hits parked in TEXG, TEXG lanes, REFILL lanes
    that start a sample and that retire, sanitized samples (NaN, inf,
    negatives, fireflies), DONE lanes; over textures on and off, smooth
    shading and UV mapping on and off, 0, 1 and 17 lights, one or two
    trimat rows a table row, and the firefly clamp on and off;
  - the dispatch: on the CPU the round loop takes the plain version and
    never loads the kernel;
  - the host packing of the kernel's parameters;
  - on a card (``cuda``-marked, skipped elsewhere): the kernel against
    the plain version on the same states, a round on the card taking
    the kernel, and the wrapper's refusals.

Tolerance against the JAX block: every int and bool field and both ray
counts exactly; float fields within the JAX engine test's _ULP (rtol
2e-6, atol 1e-6; NaN equal to NaN).  The JAX block runs op by op, but it
takes cos, sin and pow in float32 where the port goes through float64
(core/vec.py), so a few directions and throughputs differ in the last
bit (7 of 1,152 direction floats in the "base" case).  The kernel
against the plain version: tolerance 0 (-0.0 equal to 0.0, see
ops/service.py).
"""

import numpy as np
import pytest
import torch

from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import persistent
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import service, walk
from tryraytrace_tpu_torch.ops._build import KernelLibrary
from tryraytrace_tpu_torch.ops.shade import INV_PI, TWO_PI
from tryraytrace_tpu_torch.scene import objloader
from tryraytrace_tpu_torch.scene.assets import checker_texture, cube_mesh
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, flatten_scene

from test_torch_features import write_uv_sphere

torch.set_num_threads(1)

W, H = 24, 16          # 384 lanes
FRAME = 5
SPP_CAP, SEED_SPP, SAMPLE_OFFSET = 2, 3, 1
# name -> (textured, lights, leaf size (4: one trimat row a table row,
# 8: two), smooth shading, UV mapping, firefly clamp)
CASES = {
    "base": (True, 1, 4, False, False, True),
    "untextured_pack2": (False, 1, 8, False, False, True),
    "smooth_untextured": (False, 1, 4, True, False, True),
    "uv_pack2": (True, 1, 8, False, True, True),
    "smooth_uv_17_lights": (True, 17, 4, True, True, True),
    "no_lights_pack2": (True, 0, 8, False, False, True),
    "17_lights_pack2_no_clamp": (False, 17, 8, False, False, False),
    "no_clamp_no_floor": (True, 1, 4, False, False, False),
    "all": (True, 17, 8, True, True, False),
}


@pytest.fixture(scope="module")
def sphere_obj(tmp_path_factory):
    path = tmp_path_factory.mktemp("obj") / "uv_sphere.obj"
    write_uv_sphere(path)
    return str(path)


def _arrays(sphere_obj, textured: bool, lights: int):
    """Cornell box, a UV sphere with vertex normals (texture slot 0), a
    glass cube and a rough metal cube; with textures a floor quad on slot
    1 and a triangle on slot 7 (past the last: factor 1); ``lights``
    emitters (the box's own, dimmed to none for 0, and small ones under
    the ceiling)."""
    scene = create_cornell_box(mesh=None)
    if lights == 0:
        for obj in scene.objects:
            obj.emission = (0.0, 0.0, 0.0)
    objloader.load_obj(sphere_obj, scene.objects, offset=(50.0, 25.0, 60.0),
                       scale=20.0, parse_uv=True, tex_id=0)
    v0, v1, v2 = cube_mesh()
    for off, mat in (((30, 20, 90), dict(albedo=(0.95, 0.95, 0.95),
                                         ior=1.45, transmission=1.0)),
                     ((70, 15, 80), dict(albedo=(0.8, 0.6, 0.3),
                                         metallic=1.0, roughness=0.3))):
        for a, b, c in zip(v0 * 10 + off, v1 * 10 + off, v2 * 10 + off):
            scene.objects.append(Object(v0=tuple(a), v1=tuple(b),
                                        v2=tuple(c), **mat))
    if textured:
        quad = ((-40, 0.5, -40), (140, 0.5, -40), (140, 0.5, 290),
                (-40, 0.5, 290))
        for ia, ib, ic in ((0, 1, 2), (0, 2, 3)):
            scene.objects.append(Object(v0=quad[ia], v1=quad[ib],
                                        v2=quad[ic], roughness=1.0,
                                        albedo=(0.85, 0.85, 0.85), tex_id=1))
        scene.objects.append(Object(v0=(20, 5, 120), v1=(40, 5, 120),
                                    v2=(30, 30, 120), tex_id=7))
    for i in range(max(0, lights - 1)):
        x = 10.0 + 4 * i
        scene.objects.append(Object(v0=(x, 99.0, 40), v1=(x + 2, 99.0, 40),
                                    v2=(x + 1, 99.0, 42),
                                    emission=(5.0, 5.0, 5.0)))
    textures = ([checker_texture(8), 1.0 - checker_texture(4)] if textured
                else [])
    return flatten_scene(scene, textures=textures)


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _case(sphere_obj, name, device="cpu", seed=0):
    """(scene arrays, Renderer, _Frame, state) of one case on
    ``device``: the camera
    rays' closest-hit walks run to their end (SHADEG lanes on real
    hits), then a seed-made share of the lanes rewritten into every
    other kind."""
    textured, lights, leaf, smooth, uv, clamp = CASES[name]
    arrays = _arrays(sphere_obj, textured, lights)
    cfg = RenderConfig(width=W, height=H, spp=SPP_CAP, bvh_leaf_size=leaf,
                       smooth_shading=smooth, uv_mapping=uv,
                       clamp_fireflies=clamp, nee_dist_floor_enabled=clamp)
    r = Renderer(arrays, cfg=cfg, device="cpu")
    assert r.inline.pack == (2 if leaf == 8 else 1)
    assert r.scene.num_lights == lights
    assert (r.inline.tex0 is not None) == textured
    ctl = CameraController()
    ctl.aperture = 2.0
    cam = ctl.get_params(W, H).to("cpu")
    n = W * H
    s = persistent.init_lane_ctx(FRAME, SEED_SPP, torch.arange(n), cam, W, H,
                                 cfg, with_tstash=textured,
                                 sample_offset=SAMPLE_OFFSET)
    s, _ = walk.quad_walk(s, r.inline.walk, r.inline.sentinel,
                          r.scene.leaf_size, fmt=r.scene.leaf_fmt)
    rs = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    kinds = rs.choice(8, n, p=[0.3, 0.15, 0.05, 0.15, 0.2, 0.05, 0.05,
                               0.05])
    mode = s["mode"].numpy().copy()
    hit = s["hit_id"].numpy().copy()
    d_min = s["d_min"].numpy().copy()
    cur = s["cur"].numpy().copy()
    n_tris = int(r.scene.trimat.shape[0])
    k = kinds == 1                         # SHADEG on any triangle
    mode[k], hit[k] = walk.SHADEG, rs.randint(0, n_tris, int(k.sum()))
    d_min[k] = rs.uniform(0.5, 200.0, int(k.sum()))
    k = kinds == 2                         # SHADEG on a miss
    mode[k], hit[k] = walk.SHADEG, -1
    k = kinds == 3                         # TEXG (with textures)
    if textured:
        tiles = int(r.inline.table.shape[0]) - r.inline.tex0
        mode[k] = walk.TEXG
        cur[k] = r.inline.tex0 + rs.randint(0, tiles, int(k.sum()))
        hit[k] = rs.randint(0, 16, int(k.sum()))
    k = kinds == 4                         # REFILL
    mode[k] = walk.REFILL
    for kind, m in ((5, walk.DONE), (6, walk.TRAVERSE), (7, walk.SHADOW)):
        mode[kinds == kind] = m
        cur[kinds == kind] = 0             # a walk to start
    rad = rs.uniform(0.0, 3.0, (n, 3)).astype(np.float32)
    bad = rs.choice(6, n, p=[0.6, 0.08, 0.08, 0.08, 0.08, 0.08])
    rad[bad == 1, 0] = np.nan
    rad[bad == 2, 1] = np.inf
    rad[bad == 3, 2] = -1.0
    rad[bad == 4] = 500.0
    rad[bad == 5] = -0.0
    tstash = np.concatenate([
        rs.uniform(0, 1, (n, 3)), rs.choice([0.0, 0.5, 1.0], (n, 1)),
        rs.uniform(0, 1, (n, 1)), rs.uniform(1, 2, (n, 1)),
        rs.choice([0.0, 1.0], (n, 1)), rs.uniform(0, 1, (n, 2)),
        rs.choice([0.0, 1.0], (n, 1))], axis=1).astype(np.float32)
    s.update(
        mode=t(mode), hit_id=t(hit), d_min=t(d_min), cur=t(cur), rad=t(rad),
        depth=t(rs.randint(0, cfg.max_depth, n).astype(np.int64)),
        sample=t(rs.randint(0, SPP_CAP, n).astype(np.int64)),
        tp=t(rs.uniform(0.1, 1.0, (n, 3)).astype(np.float32)),
        prev_spec=t(rs.rand(n) < 0.5),
        cont_after_shadow=t(rs.rand(n) < 0.5),
        so=t(_unit(rs, n)), sd=t(_unit(rs, n)),
        smax=t(rs.uniform(1, 100, n).astype(np.float32)),
        pend=t(np.where(rs.rand(n, 1) < 0.2, 5.0, 0.0).astype(np.float32)
               * np.ones((1, 3), np.float32)),
        out=t(rs.uniform(0, 2, (n, 3)).astype(np.float32)))
    if textured:
        s["tstash"] = t(tstash)
    if device != "cpu":
        r = Renderer(arrays, cfg=cfg, device=device)
        cam = cam.to(device)
        s = {key: val.to(device) for key, val in s.items()}
    fr = persistent._Frame(r.scene, r.inline, cfg, cam, FRAME, W, H, SPP_CAP,
                           SEED_SPP, SAMPLE_OFFSET)
    return arrays, r, fr, s


def _same(a, b) -> bool:
    """Equal as numbers (-0.0 == 0.0), NaN equal to NaN."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    eq = a == b
    if a.is_floating_point():
        eq = eq | (a.isnan() & b.isnan())
    return bool(eq.all())


def _jax_service(arrays, r, fr, s):
    """The JAX engine's service block on the port's state, op by op."""
    import jax.numpy as jnp

    from tryraytrace_tpu.camera.controller import CameraParams as JCam
    from tryraytrace_tpu.config import RenderConfig as JConfig
    from tryraytrace_tpu.engine import device_scene as jdevice_scene
    from tryraytrace_tpu.engine import persistent as jp

    cfg = fr.cfg
    jcfg = JConfig(width=W, height=H, spp=SPP_CAP, inline_tex=True,
                   smooth_shading=cfg.smooth_shading,
                   uv_mapping=cfg.uv_mapping,
                   clamp_fireflies=cfg.clamp_fireflies,
                   nee_dist_floor_enabled=cfg.nee_dist_floor_enabled)
    jdev, jtex, _ = jdevice_scene.upload_scene(
        arrays, device_put=False, leaf_size=r.scene.leaf_size,
        method="sah", leaf_fmt="bw", quad_collapse="dp", quad_layout="mux")
    for name in ("quad_table", "trimat"):
        assert np.asarray(getattr(jdev, name)).tobytes() == getattr(
            r.scene, name).numpy().tobytes(), name
    cam = fr.cam
    jcam = JCam(*(np.asarray(getattr(cam, f)) for f in
                  ("pos", "cx", "cy", "dir", "lens_radius", "focus_dist")))
    n = W * H
    sentinel = int(jdev.quad_table.shape[0])
    table, ctx = jp.build_inline_table(
        jdev.quad_table, sentinel, jdev, jtex, jcfg, jcam,
        jnp.uint32(FRAME), jnp.arange(n, dtype=jnp.int32), W, H, SPP_CAP,
        SAMPLE_OFFSET, SEED_SPP, 1, n)
    assert np.asarray(table).tobytes() == r.inline.table.numpy().tobytes()
    ints = ("mode", "cur", "hit_id", "depth", "sample", "pix")
    js = {key: jnp.asarray(val.numpy().astype(np.int32) if key in ints
                           else val.numpy())
          for key, val in s.items() if key not in ("reg_e", "reg_s")}
    js["seed"] = jnp.asarray(s["seed"].numpy().astype(np.uint32))
    js["n_traced"] = jnp.float32(0.0)
    js["n_shadow"] = jnp.float32(0.0)
    tex_ctx = ctx["tex"]
    idx, live_g, live_x = jp._service_select(
        js, jnp.zeros(n, jnp.int32), sentinel, ctx, tex_ctx)
    return jp._service_shade(js, js, table[idx], live_g, live_x, ctx,
                             tex_ctx)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_pass_matches_jax_service_block(name, sphere_obj):
    arrays, r, fr, s = _case(sphere_obj, name)
    modes = torch.bincount(s["mode"], minlength=walk.TEXG + 1).tolist()
    assert all(modes[m] for m in (walk.SHADEG, walk.REFILL, walk.DONE,
                                  walk.TRAVERSE, walk.SHADOW))
    assert bool(modes[walk.TEXG]) == CASES[name][0]
    want = _jax_service(arrays, r, fr, s)
    got, counts = persistent.service_plain(s, r.inline, fr)
    for key, _, _ in service.FIELDS:
        if key not in got:
            continue
        mine = got[key].numpy()
        theirs = np.asarray(want[key]).astype(mine.dtype)
        if mine.dtype == np.float32:
            np.testing.assert_allclose(mine, theirs, rtol=2e-6, atol=1e-6,
                                       equal_nan=True, err_msg=key)
        else:
            np.testing.assert_array_equal(mine, theirs, err_msg=key)
    cont, shadow, start = (int(c) for c in counts)
    assert cont + start == int(want["n_traced"])
    assert shadow == int(want["n_shadow"])
    # Every kind of lane was there to serve.
    new = torch.bincount(got["mode"], minlength=walk.TEXG + 1).tolist()
    assert shadow > 0 or CASES[name][1] == 0
    assert cont > 0 and start > 0
    assert new[walk.DONE] > modes[walk.DONE]
    if CASES[name][0]:
        # Textured hits were parked: TEXG lanes remain after the pass.
        assert new[walk.TEXG] > 0
    assert (got["mode"] != s["mode"]).any()


def test_round_loop_on_the_cpu_never_loads_a_kernel(monkeypatch,
                                                    sphere_obj):
    def refuse(self):
        raise AssertionError(f"{self.name} kernel loaded on the CPU")

    monkeypatch.setattr(KernelLibrary, "load", refuse)
    _, r, fr, s = _case(sphere_obj, "base")
    before = service.service_pass_cuda.launches
    got, tr, sh, rows = persistent._round_quad(s, r.inline,
                                               r.scene.leaf_size, fr)
    want, counts = persistent.service_plain(
        walk.walk_plain(s, r.inline.walk, r.inline.sentinel,
                        r.scene.leaf_size, fmt=r.scene.leaf_fmt)[0],
        r.inline, fr)
    assert all(_same(got[key], want[key]) for key in want)
    assert int(tr) == int(counts[0]) + int(counts[2])
    assert int(sh) == int(counts[1])
    assert fr.service is None
    assert service.service_pass_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        service.service_pass_cuda(s, r.inline, service.service_params(fr))


@pytest.mark.parametrize("name", ["base", "all", "no_lights_pack2"])
def test_host_packing_of_the_parameters(name, sphere_obj):
    _, r, fr, _ = _case(sphere_obj, name)
    p = service.service_params(fr)
    pf = lambda key: p.floats[service.FLOATS.index(key)]
    pi = lambda key: int(p.ints[service.INTS.index(key)])
    cfg, cam = fr.cfg, fr.cam
    f32 = np.float32
    assert p.floats.dtype == np.float32 and p.ints.dtype == np.int64
    assert len(p.floats) == len(service.FLOATS)
    assert len(p.ints) == len(service.INTS)
    for i, axis in enumerate("xyz"):
        for field in ("pos", "cx", "cy", "dir"):
            assert pf(f"cam_{field}_{axis}") == getattr(
                cam, field)[i].item()
    assert pf("lens_radius") == f32(1.0)
    assert pf("focus_dist") == cam.focus_dist.item()
    for key in ("rr_min_p", "emitter_stop_threshold", "shadow_eps",
                "refr_offset", "shadow_max_dist_eps", "nee_dist_sq_floor",
                "firefly_clamp", "tex_planar_scale"):
        assert pf(key) == f32(getattr(cfg, key)), key
    # What torch computes with against float32 tensors.
    lanes = torch.ones(4)
    assert pf("width") == (lanes * 0 + W)[0].item()
    n_lights = r.scene.num_lights
    assert pf("light_pick_scale") == (lanes * (n_lights - 0.001))[0]
    assert pf("light_count") == (lanes * n_lights)[0]
    assert pf("two_pi") == f32(TWO_PI) and pf("inv_pi") == f32(
        INV_PI)
    want_ints = dict(
        width=W, height=H, spp_cap=SPP_CAP, sample_offset=SAMPLE_OFFSET,
        seed_base=(1984 + FRAME * SEED_SPP) & 0xFFFFFFFF,
        sentinel=r.inline.sentinel, pack=r.inline.pack,
        tex0=-1 if r.inline.tex0 is None else r.inline.tex0,
        num_textures=len(r.inline.metas), num_lights=n_lights,
        rr_threshold=cfg.rr_threshold, max_depth=cfg.max_depth,
        nee_dist_floor_enabled=int(cfg.nee_dist_floor_enabled),
        clamp_fireflies=int(cfg.clamp_fireflies),
        smooth=int(cfg.smooth_shading), uv=int(cfg.uv_mapping),
        table_rows=r.inline.table.shape[0],
        table_width=r.inline.table.shape[1])
    assert {key: pi(key) for key in want_ints} == want_ints
    # The seed schedule's base plus a sample number is the sample's seed.
    from tryraytrace_tpu_torch.core import rng
    assert ((pi("seed_base") + 4 + SAMPLE_OFFSET) & 0xFFFFFFFF
            == rng.sample_seed(FRAME, SEED_SPP, 4 + SAMPLE_OFFSET))
    # The light rows are the table's rows of the lights.
    if n_lights:
        rows = r.scene.trimat[r.scene.light_indices[:n_lights]]
        assert torch.equal(p.lights, rows)
        assert (p.lights[:, 12:15] > 0).any(dim=1).all()
    else:
        assert p.lights.shape == (1, r.scene.trimat.shape[1])
    metas = [[m["offset"], m["tiles_x"], m["w"], m["h"]]
             for m in r.inline.metas] or [[0, 0, 0, 0]]
    assert p.metas.tolist() == metas and p.metas.dtype == torch.int64
    assert p.table is r.inline.table


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA service kernel runs only on a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernel_matches_plain_version(name, sphere_obj):
    _need_card()
    _, r, fr, s = _case(sphere_obj, name, device="cuda")
    want, want_counts = persistent.service_plain(s, r.inline, fr)
    before = service.service_pass_cuda.launches
    got, counts = service.service_pass_cuda(
        {key: val.clone() for key, val in s.items()}, r.inline,
        service.service_params(fr))
    torch.cuda.synchronize()
    assert service.service_pass_cuda.launches == before + 1
    for key, _, _ in service.FIELDS:
        if key in want:
            assert _same(got[key], want[key]), key
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.cuda
def test_cuda_round_takes_the_kernel(sphere_obj):
    _need_card()
    _, r, fr, s = _case(sphere_obj, "all", device="cuda")
    k, fmt = r.scene.leaf_size, r.scene.leaf_fmt
    walked = walk.walk_plain(s, r.inline.walk, r.inline.sentinel, k,
                             fmt=fmt)[0]
    want, counts = persistent.service_plain(walked, r.inline, fr)
    before = service.service_pass_cuda.launches
    got, tr, sh, _ = persistent._round_quad(
        {key: val.clone() for key, val in s.items()}, r.inline, k, fr)
    torch.cuda.synchronize()
    assert service.service_pass_cuda.launches == before + 1
    assert fr.service is not None
    # The fields a round writes (the walk's are among them; the plain
    # walk also leaves its skip registers, which the kernel keeps).
    bad = [key for key, _, _ in service.FIELDS
           if key in want and not _same(got[key], want[key])]
    assert not bad
    assert int(tr) == int(counts[0]) + int(counts[2])
    assert int(sh) == int(counts[1])


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_cannot_take(sphere_obj):
    _need_card()
    _, r, fr, s = _case(sphere_obj, "base", device="cuda")
    params = service.service_params(fr)
    cpu = {key: val.cpu() for key, val in s.items()}
    with pytest.raises(ValueError, match="state field 'mode'"):
        service.service_pass_cuda(cpu, r.inline, params)
    with pytest.raises(ValueError, match="'mode'"):
        service.service_pass_cuda({**s, "mode": s["mode"].to(torch.int32)},
                                  r.inline, params)
    with pytest.raises(ValueError, match="'o'"):
        service.service_pass_cuda({**s, "o": s["o"][:-1]}, r.inline, params)
    with pytest.raises(ValueError, match="'d'"):
        service.service_pass_cuda({**s, "d": s["d"].t().contiguous().t()},
                                  r.inline, params)
    with pytest.raises(ValueError, match="'tstash'"):
        service.service_pass_cuda({**s, "tstash": s["tstash"][:, :9]},
                                  r.inline, params)
    other = persistent.build_inline_table(r.scene, r.textures)
    with pytest.raises(ValueError, match="another table"):
        service.service_pass_cuda(s, other, params)

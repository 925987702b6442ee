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
  - the wave's totals (ops/service.py TOTALS): the plain pass adds its
    paths continued and camera rays started, and its shadow rays, to the
    running totals and leaves the count of lanes not DONE in the round's
    slot, zeroing the other; a whole ``Wave`` (the round loop in one
    call and in calls of three rounds, and the interleaved loop) gives
    the rounds, rays, rows and sums it gave before the kernel kept the
    counts (recorded on commit 3b52d7a, where the engine added them on
    the host);
  - the dispatch: on the CPU the round loop takes the plain version and
    never loads the kernel;
  - the host packing of the kernel's parameters;
  - on a card (``cuda``-marked, skipped elsewhere): the kernel against
    the plain version on the same states and on a state whose every
    warp mixes every mode and takes every branch, a round on the card
    taking the kernel and launching nothing for its counts, and the
    wrapper's refusals.

Tolerance against the JAX block: every int and bool field and both ray
totals exactly; float fields within the JAX engine test's _ULP (rtol
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

import chip_smoke
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
# A whole wave over the "base" scene at WAVE_W x WAVE_H (wider than
# persistent.MIN_COMPACT_WIDTH, so it compacts), SPP_CAP samples: its
# rounds (steps for the interleaved loop), path rays, shadow rays, rows
# fetched, sum of the sums and completed samples, as commit 3b52d7a
# (counts added on the host) gives them on the CPU.
WAVE_W, WAVE_H = 48, 32
WAVE_NUMBERS = dict(rounds=39, steps=232, path=21820, shadow=13078,
                    rows=107325, sums=1213.539698491064, samples=3072)
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
    totals = torch.zeros(len(service.TOTALS), dtype=torch.int64)
    got = persistent.service_plain(s, r.inline, fr, totals, 0)
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
    path, shadow, live, other = totals.tolist()
    assert path == int(want["n_traced"])
    assert shadow == int(want["n_shadow"])
    assert live == int((got["mode"] != walk.DONE).sum()) and other == 0
    # Every kind of lane was there to serve: paths continued, samples
    # started and shadow rays fired.
    new = torch.bincount(got["mode"], minlength=walk.TEXG + 1).tolist()
    served = (s["mode"] == walk.SHADEG) | (s["mode"] == walk.TEXG)
    walking = (got["mode"] == walk.TRAVERSE) | (got["mode"] == walk.SHADOW)
    started = (got["sample"] != s["sample"]) & (got["mode"] != walk.DONE)
    assert shadow > 0 or CASES[name][1] == 0
    assert bool((served & walking).any()) and bool(started.any())
    assert new[walk.DONE] > modes[walk.DONE]
    if CASES[name][0]:
        # Textured hits were parked: TEXG lanes remain after the pass.
        assert new[walk.TEXG] > 0
    assert (got["mode"] != s["mode"]).any()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_pass_adds_the_round_totals_and_live_count(name, sphere_obj):
    _, r, fr, s = _case(sphere_obj, name)
    # The pass's counts as the eager block returns them.
    idx, live_g, live_x = persistent._service_select(
        s, torch.zeros_like(s["cur"]), r.inline)
    want, cont, shadow, start = persistent._service_shade(
        s, s, r.inline.table[idx], live_g, live_x, fr)
    live = int((want["mode"] != walk.DONE).sum())
    assert 0 < live < len(s["mode"])
    for slot in (0, 1):
        totals = torch.tensor([1000, 77, 0, 0], dtype=torch.int64)
        totals[service.LIVE + 1 - slot] = 5
        got = persistent.service_plain(s, r.inline, fr, totals, slot)
        want_totals = [1000 + int(cont) + int(start), 77 + int(shadow), 0, 0]
        want_totals[service.LIVE + slot] = live
        assert totals.tolist() == want_totals
        assert all(_same(got[key], want[key]) for key in want)


@pytest.mark.parametrize("split", [None, 3])
def test_wave_gives_the_rounds_rays_rows_and_sums_of_before(split,
                                                             sphere_obj):
    arrays = _arrays(sphere_obj, True, 1)
    cfg = RenderConfig(width=WAVE_W, height=WAVE_H, spp=SPP_CAP)
    r = Renderer(arrays, cfg=cfg, device="cpu")
    cam = CameraController().get_params(WAVE_W, WAVE_H)
    n = WAVE_W * WAVE_H
    assert n > persistent.MIN_COMPACT_WIDTH
    runs = [("rounds", persistent._round_quad, 1, split)]
    if split is None:
        runs.append(("steps", persistent._step_quad,
                     persistent.LIVE_CHECK_EVERY, None))
    for key, round_fn, every, per_call in runs:
        w = persistent.Wave(r.scene, r.inline, cam, FRAME, WAVE_W, WAVE_H,
                            cfg, torch.arange(n), SPP_CAP, SEED_SPP,
                            round_fn, every, SAMPLE_OFFSET)
        calls = 1
        while not w.advance(per_call):
            calls += 1
        assert calls == (1 if per_call is None else
                         -(-WAVE_NUMBERS["rounds"] // per_call))
        assert w.state["mode"].shape[0] < n  # the wave compacted
        sums, samples = w.read()
        st = w.stats()
        assert st["iterations"] == WAVE_NUMBERS[key]
        assert (int(st["n_traced"]), int(st["n_shadow"]),
                int(st["rows_fetched"])) == tuple(
                    WAVE_NUMBERS[k] for k in ("path", "shadow", "rows"))
        assert float(sums.double().sum()) == WAVE_NUMBERS["sums"]
        assert int(samples.sum()) == WAVE_NUMBERS["samples"] == n * SPP_CAP
        # The totals are the wave's, read without being consumed.
        assert int(w.n_traced) == WAVE_NUMBERS["path"]
        assert w.totals[service.LIVE:].tolist() == [0, 0]


def test_round_loop_on_the_cpu_never_loads_a_kernel(monkeypatch,
                                                    sphere_obj):
    def refuse(self):
        raise AssertionError(f"{self.name} kernel loaded on the CPU")

    monkeypatch.setattr(KernelLibrary, "load", refuse)
    _, r, fr, s = _case(sphere_obj, "base")
    before = service.service_pass_cuda.launches
    totals = torch.zeros(len(service.TOTALS), dtype=torch.int64)
    want_totals = totals.clone()
    got, rows = persistent._round_quad(s, r.inline, r.scene.leaf_size, fr,
                                       1, totals, 1)
    walked, want_rows = walk.walk_plain(s, r.inline.walk, r.inline.sentinel,
                                        r.scene.leaf_size,
                                        fmt=r.scene.leaf_fmt)
    want = persistent.service_plain(walked, r.inline, fr, want_totals, 1)
    assert all(_same(got[key], want[key]) for key in want)
    assert totals.tolist() == want_totals.tolist()
    assert int(rows) == int(want_rows)
    assert fr.service is None
    assert service.service_pass_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        service.service_pass_cuda(s, r.inline, service.service_params(fr),
                                  totals, 0)


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


def _kernel_against_plain(s, inline, fr, slot=0):
    """The kernel and the plain pass on copies of ``s`` from the same
    totals: every field equal (tolerance 0, -0.0 == 0.0) and the totals
    equal.  Returns the plain pass's state and totals."""
    start = torch.tensor([1000, 77, 0, 0], dtype=torch.int64,
                         device=s["mode"].device)
    start[service.LIVE + 1 - slot] = 5
    want_totals, totals = start.clone(), start.clone()
    want = persistent.service_plain(s, inline, fr, want_totals, slot)
    before = service.service_pass_cuda.launches
    got = service.service_pass_cuda(
        {key: val.clone() for key, val in s.items()}, inline,
        service.service_params(fr), totals, slot)
    torch.cuda.synchronize()
    assert service.service_pass_cuda.launches == before + 1
    bad = [key for key, _, _ in service.FIELDS
           if key in want and not _same(got[key], want[key])]
    assert not bad
    assert totals.tolist() == want_totals.tolist()
    return want, want_totals


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernel_matches_plain_version(name, sphere_obj):
    _need_card()
    _, r, fr, s = _case(sphere_obj, name, device="cuda")
    for slot in (0, 1):
        _kernel_against_plain(s, r.inline, fr, slot)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_mixed_warps():
    _need_card()
    w, h = 32, 24
    r = Renderer(chip_smoke.mixed_arrays(),
                 cfg=RenderConfig(width=w, height=h, spp=1), device="cuda")
    fr, s = chip_smoke.mixed_state(r, CameraController().get_params(w, h),
                                   w, h, seed=3)
    mode = s["mode"].view(-1, 32)
    for m in (walk.SHADEG, walk.TEXG, walk.REFILL, walk.DONE, walk.TRAVERSE,
              walk.SHADOW):
        assert bool((mode == m).any(dim=1).all()), m  # in every warp
    want, _ = _kernel_against_plain(s, r.inline, fr)
    work = chip_smoke.service_work(s, fr)[2]
    for key in ("spec_smooth", "spec_rough", "trans_smooth", "trans_rough",
                "tir", "diff", "dead_retire", "dead_restart", "parked",
                "camera"):
        assert work["lanes"][key] > 0, key


@pytest.mark.cuda
def test_cuda_round_takes_the_kernel(sphere_obj):
    _need_card()
    _, r, fr, s = _case(sphere_obj, "all", device="cuda")
    k, fmt = r.scene.leaf_size, r.scene.leaf_fmt
    walked = walk.walk_plain(s, r.inline.walk, r.inline.sentinel, k,
                             fmt=fmt)[0]
    want_totals = torch.zeros(len(service.TOTALS), dtype=torch.int64,
                              device="cuda")
    totals = want_totals.clone()
    want = persistent.service_plain(walked, r.inline, fr, want_totals, 0)
    before = service.service_pass_cuda.launches
    got, _ = persistent._round_quad(
        {key: val.clone() for key, val in s.items()}, r.inline, k, fr, 1,
        totals, 0)
    torch.cuda.synchronize()
    assert service.service_pass_cuda.launches == before + 1
    assert fr.service is not None
    # The fields a round writes (the walk's are among them; the plain
    # walk also leaves its skip registers, which the kernel keeps).
    bad = [key for key, _, _ in service.FIELDS
           if key in want and not _same(got[key], want[key])]
    assert not bad
    assert totals.tolist() == want_totals.tolist()


def _kernels(fn) -> list:
    """The names of the CUDA kernels ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("Memcpy")
                  and not e.name.startswith("Memset"))


@pytest.mark.cuda
def test_cuda_round_launches_nothing_for_its_counts(sphere_obj):
    """A round of the two-kernel round loop (the route ``round_fn=
    _round_quad`` takes on a card) that does not compact launches the
    walk wrapper's kernels, the service kernel and the add of the walk's
    rows, and nothing for the ray totals or the live count."""
    _need_card()
    arrays = _arrays(sphere_obj, True, 1)
    cfg = RenderConfig(width=WAVE_W, height=WAVE_H, spp=SPP_CAP)
    r = Renderer(arrays, cfg=cfg, device="cuda")
    cam = CameraController().get_params(WAVE_W, WAVE_H)
    n = WAVE_W * WAVE_H
    wave = persistent.Wave(r.scene, r.inline, cam, FRAME, WAVE_W, WAVE_H,
                           cfg, torch.arange(n, device="cuda"), SPP_CAP,
                           SEED_SPP, persistent._round_quad)
    wave.advance(1)  # builds the service parameters and the walk's plan
    state = {key: val.clone() for key, val in wave.state.items()}
    in_round = _kernels(lambda: wave.advance(1))
    assert wave.rounds == 2 and wave.state["mode"].shape[0] == n
    in_walk = _kernels(lambda: walk.quad_walk(
        state, r.inline.walk, r.inline.sentinel, r.scene.leaf_size, 1,
        r.inline.walk_levels, fmt=r.scene.leaf_fmt))
    extra = list(in_round)
    for name in in_walk:
        extra.remove(name)
    assert len(extra) == 2, extra
    assert sum("service_pass_kernel" in name for name in extra) == 1, extra


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_cannot_take(sphere_obj):
    _need_card()
    _, r, fr, s = _case(sphere_obj, "base", device="cuda")
    params = service.service_params(fr)
    totals = torch.zeros(len(service.TOTALS), dtype=torch.int64,
                         device="cuda")
    run = lambda st, inline=r.inline, t=totals, slot=0: \
        service.service_pass_cuda(st, inline, params, t, slot)
    cpu = {key: val.cpu() for key, val in s.items()}
    with pytest.raises(ValueError, match="state field 'mode'"):
        run(cpu)
    with pytest.raises(ValueError, match="'mode'"):
        run({**s, "mode": s["mode"].to(torch.int32)})
    with pytest.raises(ValueError, match="'o'"):
        run({**s, "o": s["o"][:-1]})
    with pytest.raises(ValueError, match="'d'"):
        run({**s, "d": s["d"].t().contiguous().t()})
    with pytest.raises(ValueError, match="'tstash'"):
        run({**s, "tstash": s["tstash"][:, :9]})
    other = persistent.build_inline_table(r.scene, r.textures)
    with pytest.raises(ValueError, match="another table"):
        run(s, inline=other)
    for bad in (totals[:3], totals.to(torch.int32), totals.cpu()):
        with pytest.raises(ValueError, match="totals"):
            run(s, t=bad)
    with pytest.raises(ValueError, match="slot"):
        run(s, slot=2)

"""The bounce engine's shade, NEE add and camera rays (ops/bounce.py):
the plain versions, the tables, the wrappers' refusals and, on a card,
the kernels (csrc/bounce.cu).

On the CPU:
  - one bounce at 64 lanes of a seed-made state (bounces 0 and 4: with
    and without Russian roulette) on the Cornell box with a textured
    icosphere and a second light: ``bounce_shade_plain``, the plain
    any-hit walk and ``bounce_nee_plain`` against the JAX package's
    ``_bounce`` (tryraytrace_tpu/engine/wavefront.py:97), jitted; and
    ``bounce_rays_plain`` against the JAX package's ``generate_rays``
    and its carry;
  - the engine's ``_bounce`` (the dispatch) equal to that composition,
    byte for byte;
  - ``BounceTables`` byte-equal to the raw device textures and to
    ``trimat[light_indices]``, also after ``Renderer.refit``, and the
    Renderer's device textures its views;
  - ``bounce_params``' layout (ops/service.py FLOATS and INTS);
  - chip_smoke.py's ``texel_taps`` (the shade's byte bound) against
    the texels ``sample_bilinear_wrap`` reads;
  - each ``*_cuda`` wrapper's refusals (CPU tensors, a dtype, a shape, a
    tensor that is not contiguous or not 16-byte aligned, params packed
    for other tables), raised before any library is loaded.
  - the invariant the card's lane lists rest on: over every bounce of a
    64x48 frame (cube256 with its light, and the textured scene), a
    lane dead at a bounce's entry leaves it with rad, tp and prev_spec
    bit-equal and alive and geo_ok false;
  - the lane lists' refusals: a list or next list of another dtype,
    device or shape, a count out of range or without a list, a next
    list that overlaps the list.
On a card (``cuda``-marked, skipped elsewhere): each kernel against its
plain version on the fresh, mid (bounce 4) and late (at most 10% alive)
states of a 64x48 frame, by the contract of ops/bounce.py
(chip_smoke.py ``check_bounce_shade``, ``check_bounce_nee``,
``check_bounce_rays``), the shade and the NEE add over the list the
engine gave them and a shuffled copy, the lanes off the list poisoned
and left bit for bit as they were, the next list, sorted, the lanes
alive after: "bw" and "mt" leaves, smooth shading with UVs,
1, 3 and 17 lights, and a material whose every branch weight is 0, so
that its lanes take the diffuse branch with p = 0 and carry inf; and a
bounce step's launches (one ``bounce_rays`` a sample, one
``bounce_shade`` and one ``bounce_nee`` a bounce), the card's sums equal
to the CPU's and to a second run's.

Tolerances: against the JAX package, tests/test_torch_bounce.py's rule
(masks and the shadow-ray count equal, floats within rtol
``RTOL_FUSED`` and atol ``ATOL_JAX``: XLA:CPU fuses the JAX block's
arithmetic); ``generate_rays`` within tests/test_torch_lane_init.py's
rtol 1e-6; the tables, the dispatch and the kernels bit for bit.

This file compiles one small JAX program, the jitted ``_bounce`` at 64
lanes (seconds), against the port tests' rule of compiling none: the
JAX block of one bounce has no other reference that runs it as the JAX
engine does.  The JAX package is imported inside the tests that compare
with it, so the card's tests run where jax is missing.
"""

import contextlib
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import wavefront
from tryraytrace_tpu_torch.engine.device_scene import device_textures
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import bounce, service
from tryraytrace_tpu_torch.ops import traverse as ttrav
from tryraytrace_tpu_torch.ops._build import KernelLibrary

torch.set_num_threads(1)

W, H = 16, 12
LANES = 64
ATOL_JAX = 2e-5     # tests/test_torch_bounce.py
RTOL_FUSED = 1e-5   # tests/test_torch_ops.py
RTOL_RAYS = 1e-6    # tests/test_torch_lane_init.py
CARD_W, CARD_H = 64, 48
SEED = 1987


def _scene(jax_package=False, p0=False, lights=2):
    """The Cornell box and an icosphere(1) textured with slot 0 (a
    checker), with ``lights - 1`` small emitters under the ceiling beside
    the box's light; built by the port's scene modules or the JAX
    package's (the same arrays).  ``p0``: the icosphere's material has
    f0 = 0.04 * 0.5 + 1.96 * 0.5 = 1, so Fresnel is 1 at every angle, no
    specular weight at roughness 1 and no transmission weight at
    transmission 1: every weight is 0 and the diffuse branch is taken
    with p = 1 - 0 - 1 * 1 = 0 (throughput inf)."""
    if jax_package:
        from tryraytrace_tpu.scene import assets, cornell, model
    else:
        from tryraytrace_tpu_torch.scene import assets, cornell, model
    scene = cornell.create_cornell_box(mesh=None)
    material = (dict(albedo=(1.96, 1.96, 1.96), metallic=0.5, roughness=1.0,
                     transmission=1.0, ior=1.5) if p0 else
                dict(albedo=(0.7, 0.6, 0.5), metallic=0.3, roughness=0.4,
                     tex_id=0))
    v0, v1, v2 = assets.icosphere_mesh(1, 15.0)
    for a, b, c in zip(v0 + [50, 25, 50], v1 + [50, 25, 50],
                       v2 + [50, 25, 50]):
        scene.objects.append(model.Object(v0=tuple(a), v1=tuple(b),
                                          v2=tuple(c), **material))
    for i in range(lights - 1):
        x = 20.0 + 25 * i
        scene.objects.append(model.Object(
            v0=(x, 99.0, 40.0), v1=(x + 6, 99.0, 40.0),
            v2=(x + 3, 99.0, 46.0), emission=(4.0, 4.0, 4.0)))
    return model.flatten_scene(scene,
                               textures=[assets.checker_texture(32)])


def _state(seed: int, n: int = LANES) -> dict:
    """A seed-made bounce state inside the box: origins, unit
    directions, throughputs, radiance sums, 85% of the lanes alive, half
    after a specular bounce, pixels from 2**20."""
    r = np.random.RandomState(seed)
    o = r.uniform((8.0, 8.0, 8.0), (92.0, 92.0, 160.0), (n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(o=o.astype(np.float32), d=d.astype(np.float32),
                tp=r.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
                rad=r.uniform(0.0, 0.5, (n, 3)).astype(np.float32),
                alive=r.rand(n) < 0.85, prev_spec=r.rand(n) < 0.5,
                pixels=r.randint(0, 2 ** 20, n).astype(np.int64))


def _torch_state(st: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


@pytest.fixture(scope="module")
def port_renderer():
    return Renderer(_scene(), cfg=RenderConfig(width=W, height=H,
                                               engine="bounce"),
                    device="cpu")


def _plain_bounce(r, st, seed: int, depth: int):
    """The port's bounce of ``st`` by its plain parts: the plain
    closest-hit walk, bounce_shade_plain, the plain any-hit walk and
    bounce_nee_plain -> (state after, shadow rays, live lanes)."""
    scene, k, fmt = r.scene, r.scene.leaf_size, r.scene.leaf_fmt
    s = {name: st[name] for name, _, _ in bounce.STATE}
    t, hit_id, _ = ttrav.closest_hit_packed(r.inline, k, s["o"], s["d"],
                                            s["alive"], fmt=fmt)
    new, fired, live = bounce.bounce_shade_plain(
        scene, r.bounce_tables, r.cfg, seed, st["pixels"], depth, t,
        hit_id, s)
    occluded, _ = ttrav.any_hit_packed(r.inline, k, new["so"], new["sd"],
                                       new["smax"], new["geo_ok"], fmt=fmt)
    new["rad"] = bounce.bounce_nee_plain(new["rad"], new["geo_ok"],
                                         occluded, new["contrib"])
    return new, int(fired), int(live)


_JAX_BOUNCE = {}


@pytest.mark.parametrize("depth", [0, 4])
def test_bounce_plain_matches_jax(port_renderer, depth):
    import jax
    import jax.numpy as jnp
    from tryraytrace_tpu.config import RenderConfig as JConfig
    from tryraytrace_tpu.engine import wavefront as jwavefront
    from tryraytrace_tpu.engine.renderer import Renderer as JRenderer

    if "fn" not in _JAX_BOUNCE:
        jcfg = JConfig(width=W, height=H, engine="bounce")
        _JAX_BOUNCE.update(
            fn=jax.jit(jwavefront._bounce, static_argnames=("cfg",)),
            cfg=jcfg, r=JRenderer(_scene(jax_package=True), cfg=jcfg))
    jr, seed = _JAX_BOUNCE["r"], SEED + depth
    st = _state(10 + depth)
    want = _JAX_BOUNCE["fn"](
        jr.scene, jr.textures, jnp.uint32(seed),
        jnp.asarray(st["pixels"].astype(np.int32)), jnp.int32(depth),
        *(jnp.asarray(st[k]) for k in ("o", "d", "tp", "rad", "alive",
                                       "prev_spec")),
        cfg=_JAX_BOUNCE["cfg"])
    want = dict(zip(("o", "d", "tp", "rad", "alive", "prev_spec"),
                    map(np.asarray, want[:6])), n_shadow=int(want[6]))
    got, fired, live = _plain_bounce(port_renderer, _torch_state(st), seed,
                                     depth)
    assert port_renderer.scene.num_lights == 2
    assert fired == want["n_shadow"] and fired > 0
    for name in ("alive", "prev_spec"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    assert live == int(want["alive"].sum())
    for name in ("tp", "rad"):
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   rtol=RTOL_FUSED, atol=ATOL_JAX)
    alive = want["alive"]
    assert alive.sum() > LANES // 2
    for name in ("o", "d"):
        np.testing.assert_allclose(got[name].numpy()[alive],
                                   want[name][alive], rtol=RTOL_FUSED,
                                   atol=ATOL_JAX)


def test_bounce_rays_plain_matches_jax():
    import jax.numpy as jnp
    from tryraytrace_tpu.camera.controller import CameraController as JCam
    from tryraytrace_tpu.engine.camera_rays import generate_rays

    pixels = np.random.RandomState(3).randint(0, W * H, LANES)
    jo, jd = generate_rays(JCam().get_params(W, H), W, H, jnp.uint32(SEED),
                           jnp.asarray(pixels.astype(np.int32)))
    got = bounce.bounce_rays_plain(CameraController().get_params(W, H), W,
                                   H, SEED, torch.from_numpy(pixels))
    np.testing.assert_allclose(got["o"].numpy(), np.asarray(jo),
                               rtol=RTOL_RAYS)
    np.testing.assert_allclose(got["d"].numpy(), np.asarray(jd),
                               rtol=RTOL_RAYS)
    # The JAX carry (wavefront.py:64-74): tp 1, rad 0, alive, prev_spec.
    assert (got["tp"] == 1.0).all() and (got["rad"] == 0.0).all()
    assert got["rad"].dtype == torch.float32
    assert got["alive"].all() and got["prev_spec"].all()


def test_engine_bounce_is_the_plain_composition(port_renderer):
    r = port_renderer
    st = _torch_state(_state(21))
    want, fired, live = _plain_bounce(r, st, SEED, 5)
    n = int(st["pixels"].shape[0])
    s = {name: st[name] for name, _, _ in bounce.STATE}
    s.update(bounce.new_nee_state(n, "cpu"))
    counts = torch.zeros(len(bounce.COUNTS), dtype=torch.int64)
    rows = wavefront._bounce(
        r.scene, r.inline, r.bounce_tables,
        bounce.bounce_params(r.scene, r.bounce_tables, r.cfg), SEED,
        st["pixels"], 5, s, counts)
    assert counts.tolist() == [fired, live]
    assert len(rows) == 2 and all(x.dtype == torch.int64 for x in rows)
    for name, _, _ in bounce.STATE:
        assert torch.equal(chip_smoke._bits(s[name]),
                           chip_smoke._bits(want[name])), name


@pytest.mark.parametrize("kind", ["cube256", "textured"])
def test_dead_lanes_leave_a_bounce_unchanged(kind, monkeypatch):
    """The invariant the card's lane lists rest on (ops/bounce.py): over
    every bounce of a 64x48 bounce frame on the plain path, a lane dead
    at the bounce's entry leaves it with rad, tp and prev_spec bit-equal
    to their inputs and alive and geo_ok false, so a shade over the
    lanes alive at entry may leave the others alone."""
    arrays = chip_smoke.cube256_arrays() if kind == "cube256" else _scene()
    r = Renderer(arrays, cfg=RenderConfig(width=CARD_W, height=CARD_H,
                                          engine="bounce"), device="cpu")
    assert r.scene.num_lights > 0
    real = bounce.bounce_shade
    seen = []

    def shade(scene, tables, params, seed, pixels, depth, t, hit_id, s,
              counts, *lists):
        before = chip_smoke._copy(s)
        out = real(scene, tables, params, seed, pixels, depth, t, hit_id, s,
                   counts, *lists)
        dead = ~before["alive"]
        for name in ("rad", "tp", "prev_spec"):
            assert torch.equal(chip_smoke._bits(out[name][dead]),
                               chip_smoke._bits(before[name][dead])), \
                (depth, name)
        assert not (out["alive"] | out["geo_ok"])[dead].any(), depth
        seen.append((depth, int(dead.sum())))
        return out

    monkeypatch.setattr(bounce, "bounce_shade", shade)
    _, st = wavefront.render_frame(
        r.scene, r.inline, r.device_textures,
        CameraController().get_params(CARD_W, CARD_H), 1, CARD_W, CARD_H,
        r.cfg, 1, tables=r.bounce_tables)
    assert [d for d, _ in seen] == list(range(st["iterations"]))
    # Lanes die along the way, so the later bounces test the invariant.
    assert seen[0][1] == 0 and seen[-1][1] > CARD_W * CARD_H // 2


def _check_tables(r):
    tables = r.bounce_tables
    raw = device_textures(r.textures, r.device)
    assert isinstance(tables, bounce.BounceTables)
    # The engine's device textures are the tables' views of one buffer.
    assert r.device_textures is tables.textures
    assert len(tables.textures) == len(raw) == 1
    for view, t in zip(tables.textures, raw):
        assert view.shape == t.shape
        assert torch.equal(chip_smoke._bits(view), chip_smoke._bits(t))
    assert torch.equal(chip_smoke._bits(tables.texels), chip_smoke._bits(
        torch.cat([t.reshape(-1) for t in raw])))
    offsets = np.cumsum([0] + [t.numel() for t in raw])[:-1]
    assert tables.metas.tolist() == [
        [int(off), int(t.shape[1]), int(t.shape[0])]
        for off, t in zip(offsets, raw)]
    n = r.scene.num_lights
    lights = r.scene.trimat[r.scene.light_indices[:n]]
    assert tables.lights.shape == (n, bounce.TRIMAT_ROW)
    assert torch.equal(chip_smoke._bits(tables.lights),
                       chip_smoke._bits(lights))
    assert tables.texels.data_ptr() % 16 == 0
    return tables


def test_bounce_tables_follow_refit():
    arrays = _scene()
    r = Renderer(arrays, cfg=RenderConfig(width=W, height=H,
                                          engine="bounce"), device="cpu")
    old = _check_tables(r)
    moved = dataclasses.replace(arrays)
    shift = np.random.RandomState(2).normal(0, 0.5, 3).astype(np.float32)
    for field in ("tri_v0", "tri_v1", "tri_v2"):
        setattr(moved, field, getattr(arrays, field) + shift)
    r.refit(moved)
    new = _check_tables(r)
    assert new is not old and not torch.equal(new.lights, old.lights)
    built = bounce.bounce_tables(r.scene, r.textures)
    assert torch.equal(built.texels, new.texels)
    assert torch.equal(built.lights, new.lights)


def test_texel_taps_are_the_texels_sampled():
    """chip_smoke.texel_taps (the shade's byte bound counts each distinct
    tap once) names exactly the texels sample_bilinear_wrap reads: the
    sample is 1 with only the taps set to 1, and 0 with only them 0."""
    from tryraytrace_tpu_torch.ops.texture import sample_bilinear_wrap

    r = np.random.RandomState(5)
    w, h = 7, 5
    u = torch.from_numpy(r.uniform(-3, 3, 200).astype(np.float32))
    v = torch.from_numpy(r.uniform(-3, 3, 200).astype(np.float32))
    taps = chip_smoke.texel_taps(u, v, w, h)
    assert taps.shape == (200, 4) and int(taps.min()) >= 0
    assert int(taps.max()) < w * h
    for k in range(200):
        on = torch.zeros(h * w, 3)
        on[taps[k]] = 1.0
        one = sample_bilinear_wrap(on.view(h, w, 3), u[k:k + 1], v[k:k + 1])
        zero = sample_bilinear_wrap((1.0 - on).view(h, w, 3), u[k:k + 1],
                                    v[k:k + 1])
        assert torch.allclose(one, torch.ones(1, 3), atol=1e-6)
        assert torch.equal(zero, torch.zeros(1, 3))


def test_bounce_params_layout(port_renderer):
    r = port_renderer
    cam = CameraController().get_params(W, H)
    p = bounce.bounce_params(r.scene, r.bounce_tables, r.cfg, W, H, cam)
    f = dict(zip(service.FLOATS, p.floats.tolist()))
    i = dict(zip(service.INTS, p.ints.tolist()))
    assert p.floats.dtype == np.float32 and p.ints.dtype == np.int64
    assert [f["cam_pos_x"], f["cam_pos_y"], f["cam_pos_z"]] == \
        cam.pos.tolist()
    assert f["lens_radius"] == float(cam.lens_radius)
    assert (f["width"], f["height"], i["width"], i["height"]) == (W, H, W, H)
    assert f["light_pick_scale"] == float(np.float32(2 - 0.001))
    assert (f["light_count"], i["num_lights"], i["num_textures"]) == (2, 2,
                                                                        1)
    assert f["shadow_eps"] == float(np.float32(r.cfg.shadow_eps))
    assert (i["smooth"], i["uv"]) == (0, 0)
    # The slots the bounce kernels do not read are 0.
    assert (i["spp_cap"], i["sentinel"], i["table_rows"]) == (0, 0, 0)
    bare = bounce.bounce_params(r.scene, r.bounce_tables, r.cfg)
    assert bare.cam is None and not bare.floats[:14].any()
    assert np.array_equal(bare.floats[16:], p.floats[16:])


# -- the wrappers' refusals ---------------------------------------------------

def _refuse(self):
    raise AssertionError(f"loaded {self.name}")


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past 16."""
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_cuda_wrappers_refuse_before_loading(port_renderer, monkeypatch):
    monkeypatch.setattr(KernelLibrary, "load", _refuse)
    r = port_renderer
    scene, tables = r.scene, r.bounce_tables
    params = bounce.bounce_params(scene, tables, r.cfg, W, H,
                                  CameraController().get_params(W, H))
    st = _torch_state(_state(4))
    pix = st["pixels"]
    n = int(pix.shape[0])
    t = torch.full((n,), 3.0)
    hit = torch.zeros(n, dtype=torch.int64)
    counts = torch.zeros(2, dtype=torch.int64)
    s = {name: st[name] for name, _, _ in bounce.STATE}
    s.update(bounce.new_nee_state(n, "cpu"))
    lanes = torch.arange(n, dtype=torch.int32)
    buf = torch.zeros(n + 4, dtype=torch.int32)

    def shade(**kw):
        a = dict(scene=scene, tables=tables, params=params, seed=1,
                 pixels=pix, depth=0, t=t, hit_id=hit, s=s, counts=counts)
        a.update(kw)
        return bounce.bounce_shade_cuda(**a)

    def nee(**kw):
        a = dict(s=dict(rad=s["rad"], geo_ok=s["geo_ok"],
                        contrib=s["contrib"]),
                 occluded=torch.zeros(n, dtype=torch.bool))
        a.update(kw)
        return bounce.bounce_nee_cuda(**a)

    cases = [
        (lambda: bounce.bounce_rays_cuda(params, 1, pix), "CUDA tensors"),
        (lambda: bounce.bounce_rays_cuda(params, 1, pix.int()), "int64"),
        (lambda: bounce.bounce_rays_cuda(params, 1, pix[::2]),
         "contiguous"),
        (lambda: bounce.bounce_rays_cuda(params, 1, _misaligned(pix)),
         "16-byte aligned"),
        (lambda: bounce.bounce_rays_cuda(dataclasses.replace(
            params, floats=params.floats[:-1]), 1, pix), "layout"),
        (lambda: bounce.bounce_rays_cuda(bounce.bounce_params(
            scene, tables, r.cfg), 1, pix), "raster"),
        (lambda: shade(), "CUDA tensors"),
        (lambda: shade(t=t.double()), "float32"),
        (lambda: shade(hit_id=hit[:-1]), "shape"),
        (lambda: shade(t=_misaligned(t)), "16-byte aligned"),
        (lambda: shade(s=dict(s, tp=s["tp"].t().contiguous().t())),
         "contiguous"),
        (lambda: shade(s=dict(s, o=_misaligned(s["o"]))),
         "16-byte aligned"),
        (lambda: shade(s={k: v for k, v in s.items() if k != "geo_ok"}),
         "no field 'geo_ok'"),
        (lambda: shade(counts=counts[:1]), "shape"),
        (lambda: shade(depth=-1), "bounce -1"),
        (lambda: shade(params=dataclasses.replace(
            params, ints=params.ints * 0)), "other tables"),
        (lambda: shade(tables=dataclasses.replace(
            tables, lights=tables.lights[:1])), "shape"),
        (lambda: shade(lanes=pix, n_lanes=n), "int32"),
        (lambda: shade(lanes=lanes.to("meta"), n_lanes=n), "meta"),
        (lambda: shade(lanes=lanes[:-1], n_lanes=n - 1), "shape"),
        (lambda: shade(lanes=lanes, n_lanes=n + 1), "out of range"),
        (lambda: shade(lanes=lanes, n_lanes=-1), "out of range"),
        (lambda: shade(lanes=lanes, n_lanes=None), "out of range"),
        (lambda: shade(n_lanes=n), "without a list"),
        (lambda: shade(lanes=lanes, n_lanes=n, next_lanes=lanes),
         "aliases"),
        (lambda: shade(lanes=buf[:n], n_lanes=n, next_lanes=buf[4:4 + n]),
         "aliases"),
        (lambda: shade(next_lanes=pix), "int32"),
        (lambda: shade(next_lanes=lanes.to("meta")), "meta"),
        (lambda: shade(next_lanes=_misaligned(lanes)), "16-byte aligned"),
        (lambda: nee(), "CUDA tensors"),
        (lambda: nee(lanes=pix, n_lanes=n), "int32"),
        (lambda: nee(lanes=lanes.to("meta"), n_lanes=n), "meta"),
        (lambda: nee(lanes=lanes[:-1], n_lanes=1), "shape"),
        (lambda: nee(lanes=lanes, n_lanes=n + 1), "out of range"),
        (lambda: nee(n_lanes=1), "without a list"),
        (lambda: nee(occluded=torch.zeros(n, dtype=torch.uint8)), "bool"),
        (lambda: nee(s=dict(rad=_misaligned(s["rad"]), geo_ok=s["geo_ok"],
                            contrib=s["contrib"])), "16-byte aligned"),
        (lambda: nee(s=dict(rad=s["rad"], geo_ok=s["geo_ok"])),
         "no field 'contrib'"),
    ]
    for fn, match in cases:
        with pytest.raises(ValueError, match=match):
            fn()


def test_dispatch_takes_the_plain_version_on_the_cpu(port_renderer):
    r = port_renderer
    before = {name: getattr(bounce, f"{name}_cuda").launches
              for name in chip_smoke.BOUNCE_KERNELS}
    wavefront.render_frame(r.scene, r.inline, r.device_textures,
                           CameraController().get_params(W, H), 1, W, H,
                           r.cfg, 1)
    assert before == {name: getattr(bounce, f"{name}_cuda").launches
                      for name in chip_smoke.BOUNCE_KERNELS}


# -- on a card ----------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA bounce kernels run only on a CUDA device")


@contextlib.contextmanager
def _card_arrays(kind: str):
    """(arrays, config fields) of each card case."""
    if kind in ("bw", "mt"):
        yield _scene(lights=1), dict(leaf_isect=kind)
    elif kind == "lights3":
        yield _scene(lights=3), {}
    elif kind == "p0":
        yield _scene(p0=True), {}
    else:  # smooth shading, UVs, "mt" leaves, 17 lights
        with tempfile.TemporaryDirectory() as tmp:
            arrays, _ = chip_smoke._feature_scene(tmp, "lights")
            yield arrays, dict(smooth_shading=True, uv_mapping=True,
                               leaf_isect="mt")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bw", "mt", "lights3", "p0",
                                  "smooth_uv_lights17"])
def test_cuda_bounce_kernels_match_plain(kind):
    _cuda()
    with _card_arrays(kind) as (arrays, fields):
        rb = Renderer(arrays, cfg=RenderConfig(
            width=CARD_W, height=CARD_H, spp=1, engine="bounce", **fields))
    params = CameraController().get_params(CARD_W, CARD_H)
    states = chip_smoke.bounce_kernel_states(rb, params, CARD_W, CARD_H)
    bp = states["rays"]["params"]
    inf_lanes = 0
    n = CARD_W * CARD_H
    assert states["fresh"]["lanes"] is None
    for label in ("fresh", "mid", "late"):
        st = states[label]
        # The list the engine gave the shade and the NEE add, and a
        # shuffled copy; the lanes off it poisoned and left alone; the
        # next list, sorted, the lanes alive after (check_bounce_shade).
        res = chip_smoke.check_bounce_shade(label, rb, bp, st, timed=False)
        alive = int(st["s"]["alive"].sum())
        assert res["counts"][1] <= alive
        assert (n if st["lanes"] is None else st["n_lanes"]) == alive
        assert res["served"] == (st["n_lanes"] if res["listed"] else n)
        chip_smoke.check_bounce_nee(label, st, timed=False)
        if label != "fresh":
            assert st["lanes"].dtype == torch.int32
            assert st["n_lanes"] < n
            assert not chip_smoke._off_list(st)[st["s"]["alive"]].any()
        s = chip_smoke._copy(st["s"])
        bounce.bounce_shade_cuda(rb.scene, rb.bounce_tables, bp,
                                 st["seed"], st["pixels"], st["depth"],
                                 st["t"], st["hit_id"], s,
                                 torch.zeros(2, dtype=torch.int64,
                                             device=rb.device),
                                 st["lanes"], st["n_lanes"])
        inf_lanes += int(torch.isinf(s["tp"]).any(dim=1).sum())
    chip_smoke.check_bounce_rays(states["rays"], timed=False)
    assert (inf_lanes > 0) == (kind == "p0")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(chip_smoke.BOUNCE_VARIANTS))
def test_cuda_bounce_variants_match_plain(variant):
    """chip_smoke.BOUNCE_VARIANTS' -D builds (every bounce after 0 over
    its list; none) by the same checks, so that the mid state's list is
    held to the plain version too."""
    _cuda()
    lib = chip_smoke.bounce_variant_libraries()[variant]
    with _card_arrays("smooth_uv_lights17") as (arrays, fields):
        rb = Renderer(arrays, cfg=RenderConfig(
            width=CARD_W, height=CARD_H, spp=1, engine="bounce", **fields))
    params = CameraController().get_params(CARD_W, CARD_H)
    states = chip_smoke.bounce_kernel_states(rb, params, CARD_W, CARD_H)
    bp = states["rays"]["params"]
    listed = []
    for label in ("fresh", "mid", "late"):
        listed.append(chip_smoke.check_bounce_shade(
            label, rb, bp, states[label], timed=False,
            library=lib)["listed"])
        chip_smoke.check_bounce_nee(label, states[label], timed=False,
                                    library=lib)
    assert listed == ([False, True, True] if variant == "list_every_bounce"
                      else [False, False, False])


@pytest.mark.cuda
def test_cuda_bounce_step_launches_and_equals_cpu():
    _cuda()
    cfg = RenderConfig(width=CARD_W, height=CARD_H, spp=2, engine="bounce")
    params = CameraController().get_params(CARD_W, CARD_H)
    arrays = _scene(lights=3)
    out = {}
    for dev in ("cuda", "cpu"):
        r = Renderer(arrays, cfg=cfg, device=dev)
        before = {name: getattr(bounce, f"{name}_cuda").launches
                  for name in chip_smoke.BOUNCE_KERNELS}
        r.step(params)
        got = {name: getattr(bounce, f"{name}_cuda").launches - before[name]
               for name in chip_smoke.BOUNCE_KERNELS}
        out[dev] = (r.accum_host().tobytes(),
                    {k: int(v) for k, v in r.last_stats.items()}, got)
        if dev == "cuda":
            # Again from the start: the lists' order may change, the
            # sums may not.
            r.reset()
            r.step(params)
            assert r.accum_host().tobytes() == out[dev][0]
    bounces = out["cuda"][1]["iterations"]
    assert out["cuda"][2] == dict(bounce_rays=2, bounce_shade=bounces,
                                  bounce_nee=bounces)
    assert out["cpu"][2] == dict(bounce_rays=0, bounce_shade=0,
                                 bounce_nee=0)
    assert out["cuda"][:2] == out["cpu"][:2]


@pytest.mark.cuda
def test_cuda_wrappers_refuse_misaligned_card_tensors():
    _cuda()
    r = Renderer(_scene(), cfg=RenderConfig(width=W, height=H,
                                            engine="bounce"))
    params = bounce.bounce_params(r.scene, r.bounce_tables, r.cfg, W, H,
                                  CameraController().get_params(W, H))
    pix = torch.arange(LANES, device=r.device)
    shifted = torch.zeros(LANES + 1, dtype=torch.int64, device=r.device)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        bounce.bounce_rays_cuda(params, 1, shifted)
    s = bounce.bounce_rays_cuda(params, 1, pix)
    assert bounce.bounce_rays_cuda.launches > 0
    assert all(s[name].is_cuda for name, _, _ in bounce.STATE)

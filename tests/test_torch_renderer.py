"""The port's Renderer end to end on the CPU: against the NumPy oracle on
the golden scenes of tests/test_golden.py (MSE 1e-9, the
bit-comparability bound of the shared counter-based RNG), and against
the JAX Renderer, images and exact ray counts, on that file's mesh
scene."""

import numpy as np
import pytest
import torch

from tryraytrace_tpu.oracle.cpu_renderer import oracle_render

from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import persistent
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import wave
from tryraytrace_tpu_torch.scene.assets import checker_texture, cube_mesh
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, Scene, flatten_scene

torch.set_num_threads(1)

MSE_EXPECT = 1e-9  # tests/test_golden.py


def _mse(a, b):
    return float(((a - b) ** 2).mean())


def _render_both(arrays, w, h, spp=1, aperture=0.0, frame=1):
    cfg = RenderConfig(width=w, height=h, spp=spp)
    r = Renderer(arrays, cfg=cfg, device="cpu")
    cam = CameraController()
    cam.aperture = aperture
    params = cam.get_params(w, h)
    r.frame = frame
    r.step(params, spp=spp)
    eng = r.accum_host().reshape(-1, 3) / spp
    ora = oracle_render(arrays, params, w, h, frame_seed=frame, spp=spp,
                        cfg=cfg) / spp
    return eng, ora


def _walls():
    return flatten_scene(create_cornell_box(mesh=None),
                         textures=[checker_texture(32)])


def _mesh_scene():
    scene = create_cornell_box(mesh=None)
    v0, v1, v2 = cube_mesh()
    for a, b, c in zip(v0 * 15 + [50, 25, 50], v1 * 15 + [50, 25, 50],
                       v2 * 15 + [50, 25, 50]):
        scene.objects.append(Object(v0=tuple(a), v1=tuple(b), v2=tuple(c),
                                    albedo=(0.7, 0.6, 0.2), metallic=1.0,
                                    roughness=0.1))
    return flatten_scene(scene, textures=[checker_texture(32)])


def _two_light_scene():
    scene = create_cornell_box(mesh=None)
    for tri in (((20, 40, 598), (40, 40, 598), (40, 60, 598)),
                ((20, 40, 598), (40, 60, 598), (20, 60, 598))):
        scene.objects.append(Object(
            v0=tri[0], v1=tri[1], v2=tri[2], albedo=(0, 0, 0),
            emission=(8.0, 4.0, 1.0), roughness=1.0))
    return flatten_scene(scene, textures=[checker_texture(32)])


def _two_textures():
    scene = create_cornell_box(mesh=None)
    quad = ((-40, 0.5, -40), (140, 0.5, -40), (140, 0.5, 290),
            (-40, 0.5, 290))
    for ia, ib, ic in ((0, 1, 2), (0, 2, 3)):
        scene.objects.append(Object(
            v0=quad[ia], v1=quad[ib], v2=quad[ic],
            albedo=(0.85, 0.85, 0.85), roughness=1.0, tex_id=1))
    inv = 1.0 - checker_texture(16)
    return flatten_scene(scene, textures=[checker_texture(32), inv])


def _glass():
    scene = create_cornell_box(mesh=None)
    v0, v1, v2 = cube_mesh()
    for a, b, c in zip(v0 * 12 + [50, 20, 60], v1 * 12 + [50, 20, 60],
                       v2 * 12 + [50, 20, 60]):
        scene.objects.append(Object(v0=tuple(a), v1=tuple(b), v2=tuple(c),
                                    albedo=(0.95, 0.95, 0.95), metallic=0.0,
                                    roughness=0.0, ior=1.45,
                                    transmission=1.0))
    return flatten_scene(scene, textures=[checker_texture(32)])


def _no_lights():
    scene = Scene()
    scene.objects.append(Object(v0=(-50, 0, 0), v1=(50, 0, 600),
                                v2=(150, 0, 0), albedo=(0.75, 0.75, 0.75),
                                roughness=1.0))
    return flatten_scene(scene)


@pytest.mark.parametrize("name,build,w,h,spp,aperture,frame", [
    ("walls", _walls, 32, 24, 1, 0.0, 1),
    ("mesh_bvh", _mesh_scene, 40, 30, 2, 0.0, 1),
    ("multi_light", _two_light_scene, 32, 24, 2, 0.0, 1),
    ("two_textures", _two_textures, 32, 24, 2, 0.0, 1),
    ("depth_of_field", _walls, 32, 24, 1, 2.0, 1),
    ("glass", _glass, 32, 24, 2, 0.0, 1),
    ("later_frame", _walls, 32, 24, 4, 0.0, 3),
    ("no_lights", _no_lights, 16, 12, 1, 0.0, 1),
])
def test_golden_scene_matches_oracle(name, build, w, h, spp, aperture,
                                     frame):
    arrays = build()
    eng, ora = _render_both(arrays, w, h, spp, aperture, frame)
    assert _mse(eng, ora) < MSE_EXPECT, name
    if name == "no_lights":
        assert float(np.abs(eng).max()) == 0.0
    else:
        assert eng.mean() > 0.01


def test_progressive_three_frames_and_reset():
    arrays = _walls()
    cfg = RenderConfig(width=24, height=16, spp=1)
    r = Renderer(arrays, cfg=cfg, device="cpu")
    params = CameraController().get_params(24, 16)
    for _ in range(3):
        r.step(params)
    assert r.spp() == 3
    eng = r.accum_host().reshape(-1, 3)
    ora = sum(oracle_render(arrays, params, 24, 16, frame_seed=f, spp=1,
                            cfg=cfg) for f in (1, 2, 3))
    assert _mse(eng / 3, ora / 3) < MSE_EXPECT
    img = r.image()
    assert img.dtype == np.uint8 and img.shape == (16, 24, 3)
    with pytest.raises(ValueError):
        r.step(params, spp=2)
    r.reset()
    assert r.spp() == 0 and float(np.abs(r.accum_host()).max()) == 0.0


def test_compaction_and_check_cadence_are_exact(monkeypatch):
    arrays = _mesh_scene()
    params = CameraController().get_params(40, 30)

    def render():
        r = Renderer(arrays, cfg=RenderConfig(width=40, height=30, spp=2),
                     device="cpu")
        r.step(params)
        return r.accum_host(), r.last_stats

    def render_interleaved():
        r = Renderer(arrays, cfg=RenderConfig(width=40, height=30, spp=2),
                     device="cpu")
        acc, stats = persistent.render_frame_interleaved(
            r.scene, r.inline, params, 1, 40, 30, r.cfg, 2)
        return acc.numpy().reshape(30, 40, 3), stats

    ref, ref_stats = render()
    plain, plain_stats = render_interleaved()
    monkeypatch.setattr(persistent, "MIN_COMPACT_WIDTH", 0)
    monkeypatch.setattr(persistent, "LIVE_CHECK_EVERY", 1)
    for got, stats in (render(), render_interleaved(),
                       (plain, plain_stats)):
        np.testing.assert_array_equal(ref, got)
        assert int(stats["n_traced"]) == int(ref_stats["n_traced"])
        assert int(stats["n_shadow"]) == int(ref_stats["n_shadow"])


def test_more_than_sixteen_lights_render():
    """17 lights: past the JAX engine's inline pick (its tick path
    gathers the row); the port picks the same row at any count."""
    scene = create_cornell_box(mesh=None)
    for i in range(16):
        x = 10.0 + 4 * i
        scene.objects.append(Object(v0=(x, 99.0, 40), v1=(x + 2, 99.0, 40),
                                    v2=(x + 1, 99.0, 42),
                                    emission=(5.0, 5.0, 5.0)))
    arrays = flatten_scene(scene, textures=[checker_texture(8)])
    assert arrays.num_lights == 17
    eng, ora = _render_both(arrays, 16, 12)
    assert np.isfinite(eng).all() and eng.mean() > 0
    assert _mse(eng, ora) < MSE_EXPECT


def test_matches_jax_renderer_and_ray_counts():
    """Same scene, raster and config as test_golden.py's
    test_cornell_with_mesh_bvh, so the JAX compile cache can hit."""
    import jax
    import jax.numpy as jnp

    from tryraytrace_tpu.camera.controller import CameraController as JCam
    from tryraytrace_tpu.config import RenderConfig as JConfig
    from tryraytrace_tpu.engine.renderer import Renderer as JRenderer
    from tryraytrace_tpu.engine.wavefront import frame_ray_stats
    from tryraytrace_tpu.scene.assets import checker_texture as jchecker
    from tryraytrace_tpu.scene.assets import cube_mesh as jcube
    from tryraytrace_tpu.scene.cornell import create_cornell_box as jcornell
    from tryraytrace_tpu.scene.model import Object as JObject
    from tryraytrace_tpu.scene.model import flatten_scene as jflatten

    scene = jcornell(mesh=None)
    v0, v1, v2 = jcube()
    for a, b, c in zip(v0 * 15 + [50, 25, 50], v1 * 15 + [50, 25, 50],
                       v2 * 15 + [50, 25, 50]):
        scene.objects.append(JObject(v0=tuple(a), v1=tuple(b), v2=tuple(c),
                                     albedo=(0.7, 0.6, 0.2), metallic=1.0,
                                     roughness=0.1))
    jarrays = jflatten(scene, textures=[jchecker(32)])
    jr = JRenderer(jarrays, cfg=JConfig(width=40, height=30, spp=2))
    jparams = JCam().get_params(40, 30)
    jr.frame = 1
    jr.step(jparams, spp=2)
    want = jr.accum_host()
    tr, sh = jax.jit(frame_ray_stats,
                     static_argnames=("width", "height", "cfg", "spp"))(
        jr.scene, jr.textures, jparams, jnp.uint32(1), width=40,
        height=30, cfg=jr.cfg, spp=2)

    r = Renderer(_mesh_scene(), cfg=RenderConfig(width=40, height=30, spp=2),
                 device="cpu")
    r.step(CameraController().get_params(40, 30), spp=2)
    got = r.accum_host()
    assert _mse(got / 2, want / 2) < MSE_EXPECT
    assert r.last_stats["n_traced"].dtype == torch.int64
    assert int(r.last_stats["n_traced"]) == int(tr)
    assert int(r.last_stats["n_shadow"]) == int(sh)
    assert int(tr) > 40 * 30 * 2 and int(sh) > 0
    # The step above ran the round loop (walks to their end, then a
    # service pass), the loop a card runs; its plain version, one row
    # per lane per step, is held to the same image and counts.
    plain, stats = persistent.render_frame_interleaved(
        r.scene, r.inline, CameraController().get_params(40, 30), 1, 40, 30,
        r.cfg, 2)
    assert r.last_stats["iterations"] * 3 < stats["iterations"]
    assert _mse(plain.numpy().reshape(want.shape) / 2, want / 2) < MSE_EXPECT
    assert int(stats["n_traced"]) == int(tr)
    assert int(stats["n_shadow"]) == int(sh)
    # The plain version of the card's wave kernel (ops/wave.py: every
    # lane's rounds, no compaction) on the same frame: the same image and
    # counts, in the round loop's rounds.
    wv = persistent.Wave(r.scene, r.inline, CameraController().get_params(
        40, 30), 1, 40, 30, r.cfg, torch.arange(40 * 30), 2, 2)
    ran, live = wave.wave_advance_plain(wv.state, r.inline, wv._fr,
                                        wv.totals, wv.rows_fetched)
    assert live == 0 and ran == r.last_stats["iterations"]
    sums = wv.state["out"].numpy().reshape(want.shape)
    assert _mse(sums / 2, want / 2) < MSE_EXPECT
    assert sums.tobytes() == got.tobytes()
    assert int(wv.totals[0]) == int(tr) and int(wv.totals[1]) == int(sh)
    assert int(wv.rows_fetched) == int(r.last_stats["rows_fetched"])


def test_default_device_is_the_card_and_raises_without_one():
    """The entry points run on the card unless asked for the CPU, and
    nothing moves to the CPU on its own."""
    from tryraytrace_tpu_torch.engine.device_scene import upload_scene
    from tryraytrace_tpu_torch.engine.state import RenderState

    if torch.cuda.is_available():
        assert RenderState.zeros(4).accum.device.type == "cuda"
        return
    arrays = _walls()
    for call in (lambda: Renderer(arrays, cfg=RenderConfig(width=8, height=8)),
                 lambda: upload_scene(arrays),
                 lambda: RenderState.zeros(4)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert RenderState.zeros(4, device="cpu").accum.device.type == "cpu"

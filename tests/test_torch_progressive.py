"""The port's cross-frame progressive engine on the CPU, after
tests/test_progressive.py: under a finite spp cap it accumulates the
batch Renderer's sums exactly, a wave split across calls ends where one
call takes it, reset() discards the wave, and unbounded counts only
grow.  One test holds it against the JAX ProgressiveRenderer."""

import numpy as np
import pytest
import torch

from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine.progressive import (UNBOUNDED_SPP,
                                                      ProgressiveRenderer)
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.ops import walk, wave
from tryraytrace_tpu_torch.scene.assets import checker_texture, cube_mesh
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import Object, Scene, flatten_scene

torch.set_num_threads(1)

W, H, CAP, FRAME = 16, 12, 2, 1
MSE_EXPECT = 1e-9  # tests/test_torch_renderer.py, against the JAX engine


def _scene(cornell, cube, obj):
    """tests/test_progressive.py's fixture, built with either package's
    scene modules."""
    scene = cornell(mesh=None)
    v0, v1, v2 = cube()
    for a, b, c in zip(v0 * 14 + [40, 20, 60], v1 * 14 + [40, 20, 60],
                       v2 * 14 + [40, 20, 60]):
        scene.objects.append(obj(v0=tuple(a), v1=tuple(b), v2=tuple(c),
                                 albedo=(0.9, 0.9, 0.9), metallic=0.3,
                                 roughness=0.4))
    return scene


@pytest.fixture(scope="module")
def arrays():
    return flatten_scene(_scene(create_cornell_box, cube_mesh, Object),
                         textures=[checker_texture(32)])


@pytest.fixture(scope="module")
def batch(arrays):
    """The batch Renderer's sum and ray count at CAP spp, frame FRAME."""
    r = Renderer(arrays, cfg=RenderConfig(width=W, height=H, spp=CAP),
                 device="cpu")
    r.frame = FRAME
    r.step(CameraController().get_params(W, H))
    st = r.last_stats
    return (r.state.accum.numpy(),
            int(st["n_traced"]) + int(st["n_shadow"]))


def _progressive(arrays, chunks=(1000,), cap=CAP):
    pr = ProgressiveRenderer(arrays, cfg=RenderConfig(width=W, height=H),
                             spp_cap=cap, frame_seed=FRAME, seed_spp=cap,
                             device="cpu")
    cam = CameraController().get_params(W, H)
    for iters in chunks:
        pr.step(cam, iters)
    return pr


def test_capped_matches_batch_exactly(arrays, batch):
    pr = _progressive(arrays)
    assert pr.done()
    accum, counts = pr.snapshot()
    assert accum.dtype == np.float32 and counts.dtype == np.int32
    assert (counts == CAP).all()
    np.testing.assert_array_equal(accum, batch[0])
    assert float(accum.sum()) > 0.0
    rays = pr.rays_traced()
    assert isinstance(rays, int) and rays == batch[1]
    # Done: more rounds change nothing.
    rounds = pr.wave.rounds
    pr.step(CameraController().get_params(W, H), 5)
    assert pr.wave.rounds == rounds


def test_split_calls_equal_one_call(arrays, batch):
    # Calls of 1, 2, 3, ... rounds with a snapshot after each: reading
    # the wave must not disturb it.
    pr = ProgressiveRenderer(arrays, cfg=RenderConfig(width=W, height=H),
                             spp_cap=CAP, frame_seed=FRAME, seed_spp=CAP,
                             device="cpu")
    cam = CameraController().get_params(W, H)
    seen = np.zeros(W * H, np.int32)
    for iters in range(1, 100):
        pr.step(cam, iters)
        accum, counts = pr.snapshot()
        assert (counts >= seen).all() and (counts <= CAP).all()
        seen = counts
        if pr.done():
            break
    assert pr.done() and iters > 2
    np.testing.assert_array_equal(pr.snapshot()[0], batch[0])
    assert pr.rays_traced() == batch[1]


def test_reset_discards_state(arrays, batch):
    pr = _progressive(arrays, chunks=(3,))
    assert pr.snapshot()[1].sum() > 0 and pr.rays_traced() > 0
    pr.reset()
    accum, counts = pr.snapshot()
    assert not accum.any() and not counts.any()
    assert pr.rays_traced() == 0
    cam = CameraController().get_params(W, H)
    pr.step(cam, 1000)
    assert pr.done()
    np.testing.assert_array_equal(pr.snapshot()[0], batch[0])


def test_unbounded_counts_only_grow(arrays):
    pr = ProgressiveRenderer(arrays, cfg=RenderConfig(width=W, height=H),
                             device="cpu")
    assert pr.spp_cap == UNBOUNDED_SPP and pr.done()
    cam = CameraController().get_params(W, H)
    prev_counts, prev_rays = np.zeros(W * H, np.int32), 0
    for k in range(1, 4):
        pr.step(cam, 10)
        accum, counts = pr.snapshot()
        rays = pr.rays_traced()
        assert isinstance(rays, int) and rays > prev_rays
        assert (counts >= prev_counts).all()
        assert counts.sum() > prev_counts.sum()
        # A sample takes at least one round.
        assert counts.max() <= 10 * k
        assert not pr.done()
        assert pr.wave.state["sample"].dtype == torch.int64
        assert pr.wave.n_traced.dtype == torch.int64
        prev_counts, prev_rays = counts, rays
    img = accum / np.maximum(counts, 1)[:, None]
    assert np.isfinite(img).all() and img.mean() > 0.0


def test_an_empty_scene_raises_at_upload_in_both_packages():
    # Neither package renders a scene without triangles: both BVH
    # collapses index the root of an empty tree while uploading, so
    # ProgressiveRenderer raises before any wave exists, as the JAX
    # class does.
    from tryraytrace_tpu.engine.device_scene import upload_scene as jupload
    from tryraytrace_tpu.scene.model import Scene as JScene
    from tryraytrace_tpu.scene.model import flatten_scene as jflatten

    with pytest.raises(IndexError):
        jupload(jflatten(JScene()), traversal="quad", leaf_fmt="bw")
    with pytest.raises(IndexError):
        ProgressiveRenderer(flatten_scene(Scene()),
                            cfg=RenderConfig(width=4, height=3),
                            device="cpu")


def test_rejects_what_the_jax_class_rejects(arrays):
    for bad, match in ((dict(scheduler="pool"), "owner"),
                       (dict(scheduler="quota"), "owner"),
                       (dict(traversal="fatnode"), "traversal"),
                       (dict(engine="bounce"), "persistent")):
        with pytest.raises(ValueError, match=match):
            ProgressiveRenderer(arrays, cfg=RenderConfig(width=W, height=H,
                                                         **bad),
                                device="cpu")
    # More lights than the JAX engine's inline NEE pick covers: the JAX
    # class refuses them (its tick-free engine needs that pick); the
    # port's pick gathers the row at any light count, so it renders
    # them, and a capped wave equals the batch step.
    scene = create_cornell_box(mesh=None)
    for i in range(16):
        x = 10.0 + 4 * i
        scene.objects.append(Object(v0=(x, 99.0, 40), v1=(x + 2, 99.0, 40),
                                    v2=(x + 1, 99.0, 42),
                                    emission=(5.0, 5.0, 5.0)))
    many = flatten_scene(scene, textures=[checker_texture(8)])
    assert many.num_lights == 17
    cfg = RenderConfig(width=8, height=8)
    pr = ProgressiveRenderer(many, cfg=cfg, spp_cap=1, frame_seed=1,
                             seed_spp=1, device="cpu")
    params = CameraController().get_params(8, 8)
    pr.step(params, 1 << 20)
    accum, counts = pr.snapshot()
    r = Renderer(many, cfg=cfg, device="cpu")
    r.step(params)
    assert pr.done() and (counts == 1).all()
    assert accum.tobytes() == r.state.accum.numpy().tobytes()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ProgressiveRenderer(flatten_scene(Scene()),
                            cfg=RenderConfig(width=4, height=4))


def test_matches_jax_progressive_renderer(arrays):
    """The JAX ProgressiveRenderer and the port's on the same scene, both
    run to done(): equal counts, per-pixel means within MSE_EXPECT, and
    the port's int64 ray total equal to the JAX class's float total."""
    from tryraytrace_tpu.camera.controller import CameraController as JCam
    from tryraytrace_tpu.config import RenderConfig as JConfig
    from tryraytrace_tpu.engine.progressive import (
        ProgressiveRenderer as JProgressive)
    from tryraytrace_tpu.scene.assets import checker_texture as jchecker
    from tryraytrace_tpu.scene.assets import cube_mesh as jcube
    from tryraytrace_tpu.scene.cornell import create_cornell_box as jcornell
    from tryraytrace_tpu.scene.model import Object as JObject
    from tryraytrace_tpu.scene.model import flatten_scene as jflatten

    jarrays = jflatten(_scene(jcornell, jcube, JObject),
                       textures=[jchecker(32)])
    jpr = JProgressive(jarrays, cfg=JConfig(width=W, height=H), spp_cap=CAP,
                       frame_seed=FRAME, seed_spp=CAP)
    jcam = JCam().get_params(W, H)
    for _ in range(200):
        jpr.step(jcam, 40)
        if jpr.done():
            break
    assert jpr.done()
    want, want_counts = jpr.snapshot()

    pr = _progressive(arrays)
    got, counts = pr.snapshot()
    np.testing.assert_array_equal(counts, want_counts)
    assert (counts == CAP).all()
    mean = lambda acc, c: acc / np.maximum(c, 1)[:, None]
    mse = float(((mean(got, counts) - mean(want, want_counts)) ** 2).mean())
    assert mse < MSE_EXPECT
    assert pr.rays_traced() == int(jpr.rays_traced()) > W * H * CAP


@pytest.mark.cuda
def test_cuda_capped_progressive_matches_batch():
    """On the card: the capped wave runs one wave-kernel launch a call
    (and no walk kernel) and its sums and ray counts equal the batch
    Renderer's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA walk kernel runs only on a CUDA device")
    arrays = flatten_scene(_scene(create_cornell_box, cube_mesh, Object),
                           textures=[checker_texture(32)])
    w, h = 64, 48
    cam = CameraController().get_params(w, h)
    r = Renderer(arrays, cfg=RenderConfig(width=w, height=h, spp=CAP))
    r.frame = FRAME
    r.step(cam)
    st = r.last_stats
    pr = ProgressiveRenderer(arrays, cfg=RenderConfig(width=w, height=h),
                             spp_cap=CAP, frame_seed=FRAME, seed_spp=CAP)
    before = (wave.wave_advance_cuda.launches, walk.quad_walk_cuda.launches)
    calls = 0
    for iters in range(1, 100):
        pr.step(cam, iters)
        calls += 1
        pr.snapshot()
        if pr.done():
            break
    assert wave.wave_advance_cuda.launches - before[0] == calls > 1
    assert walk.quad_walk_cuda.launches == before[1]
    # Every call but the last ran its whole budget of 1, 2, 3, ... rounds.
    assert sum(range(1, calls)) < pr.wave.rounds <= sum(range(1, calls + 1))
    accum, counts = pr.snapshot()
    assert (counts == CAP).all()
    assert torch.equal(torch.from_numpy(accum), r.state.accum.cpu())
    assert pr.rays_traced() == int(st["n_traced"]) + int(st["n_shadow"])

"""The rest of the port's Renderer surface on the CPU: .npz checkpoints
that load in both packages, step_tiled bit-identical to step (after
tests/test_tiled.py), image(on_device=False) equal to image(), and the
snapshot writer byte-equal to the JAX package's.  No JAX program is
compiled."""

import time

import numpy as np
import pytest
import torch

from tryraytrace_tpu.camera.controller import CameraController as JCam
from tryraytrace_tpu.engine import state as jstate
from tryraytrace_tpu.io import snapshot as jsnapshot

from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.engine import state
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.io import snapshot
from tryraytrace_tpu_torch.ops import walk, wave
from tryraytrace_tpu_torch.scene.assets import checker_texture
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import flatten_scene

torch.set_num_threads(1)

CAM_FIELDS = ("pos", "yaw", "pitch", "aperture", "focus_dist", "dir",
              "right", "up")


@pytest.fixture(scope="module")
def arrays():
    return flatten_scene(create_cornell_box(mesh=None),
                         textures=[checker_texture(16)])


def _camera(cls):
    cam = cls((41.5, 47.25, 280.0))
    cam.yaw, cam.pitch = -83.5, 4.25
    cam.aperture, cam.focus_dist = 1.3, 212.0
    cam._update_camera_vectors()
    return cam


def _same_camera(a, b):
    for name in CAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)))


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path):
    accum = np.random.RandomState(3).normal(size=(6 * 4, 3)).astype(
        np.float32)
    st = state.RenderState(torch.from_numpy(accum), 5)
    path = tmp_path / "port.npz"
    state.save_checkpoint(path, st, 6, 4, camera=_camera(CameraController),
                          frame_seed=6)
    got, w, h, frame_seed, cam = jstate.load_checkpoint(str(path))
    assert (w, h, frame_seed) == (6, 4, 6)
    assert np.asarray(got.accum).tobytes() == accum.tobytes()
    assert np.asarray(got.spp).dtype == np.int32 and int(got.spp) == 5
    _same_camera(cam, _camera(JCam))
    # The archives of both packages hold the same keys, dtypes and bytes.
    jstate.save_checkpoint(str(tmp_path / "jax.npz"), got, 6, 4,
                           camera=_camera(JCam), frame_seed=6)
    mine, theirs = _npz(path), _npz(tmp_path / "jax.npz")
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        assert mine[key].dtype == theirs[key].dtype, key
        assert mine[key].tobytes() == theirs[key].tobytes(), key


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
    accum = np.random.RandomState(4).uniform(0, 3, (8 * 3, 3)).astype(
        np.float32)
    path = str(tmp_path / "jax.npz")
    jstate.save_checkpoint(path, jstate.RenderState(accum, np.int32(7)), 8,
                           3, camera=_camera(JCam), frame_seed=8)
    got, w, h, frame_seed, cam = state.load_checkpoint(path, device="cpu")
    assert (w, h, frame_seed) == (8, 3, 8)
    assert got.accum.dtype == torch.float32
    assert got.accum.device.type == "cpu"
    assert got.accum.numpy().tobytes() == accum.tobytes()
    assert got.spp == 7 and isinstance(got.spp, int)
    _same_camera(cam, _camera(CameraController))
    # Without a camera there is none to load.
    jstate.save_checkpoint(path, jstate.RenderState(accum, np.int32(7)), 8, 3)
    assert state.load_checkpoint(path, device="cpu")[4] is None


def test_checkpoint_needs_an_npz_path_and_a_device(tmp_path):
    st = state.RenderState(torch.zeros((4, 3)), 1)
    for bad in (tmp_path / "ckpt", tmp_path / "ckpt.orbax"):
        with pytest.raises(ValueError, match="Orbax"):
            state.save_checkpoint(bad, st, 2, 2)
        with pytest.raises(ValueError, match="Orbax"):
            state.load_checkpoint(bad, device="cpu")
    assert not list(tmp_path.iterdir())
    path = tmp_path / "ckpt.npz"
    state.save_checkpoint(path, st, 2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            state.load_checkpoint(path)


def test_resume_from_a_checkpoint_continues_exactly(arrays, tmp_path):
    cfg = RenderConfig(width=12, height=8, spp=1)
    params = CameraController().get_params(12, 8)
    r = Renderer(arrays, cfg=cfg, device="cpu")
    r.step(params)
    path = tmp_path / "resume.npz"
    state.save_checkpoint(path, r.state, 12, 8, frame_seed=r.frame)
    r.step(params)
    loaded, _, _, frame_seed, _ = state.load_checkpoint(path, device="cpu")
    r2 = Renderer(arrays, cfg=cfg, device="cpu")
    r2.state, r2.frame = loaded, frame_seed
    r2.step(params)
    assert r2.spp() == r.spp() == 2
    assert torch.equal(r2.state.accum, r.state.accum)


@pytest.mark.parametrize("tiles", [3, 7, 10 ** 6])
def test_step_tiled_bit_identical(arrays, tiles):
    w, h = (32, 24) if tiles < 100 else (8, 6)
    cfg = RenderConfig(width=w, height=h, spp=2)
    params = CameraController().get_params(w, h)
    r1 = Renderer(arrays, cfg=cfg, device="cpu")
    r1.step(params)
    r2 = Renderer(arrays, cfg=cfg, device="cpu")
    r2.step_tiled(params, tiles)
    assert torch.equal(r2.state.accum, r1.state.accum)
    assert r2.spp() == 2 and r2.frame == r1.frame
    for key in ("n_traced", "n_shadow", "rows_fetched"):
        assert int(r2.last_stats[key]) == int(r1.last_stats[key])


def test_step_tiled_continues_the_seed_schedule(arrays):
    # A tiled step, then a plain step, then a tiled step: the same
    # frames and sums as three plain steps; the spp guard is shared.
    cfg = RenderConfig(width=8, height=6, spp=1)
    params = CameraController().get_params(8, 6)
    r1 = Renderer(arrays, cfg=cfg, device="cpu")
    for _ in range(3):
        r1.step(params)
    r2 = Renderer(arrays, cfg=cfg, device="cpu")
    r2.step_tiled(params, 5)
    r2.step(params)
    r2.step_tiled(params, 0)  # clamped to one tile
    assert torch.equal(r2.state.accum, r1.state.accum)
    assert r2.spp() == 3
    with pytest.raises(ValueError, match="spp changed"):
        r2.step_tiled(params, 2, spp=2)
    with pytest.raises(ValueError, match="spp changed"):
        r2.step(params, spp=2)


def test_image_on_host_equals_image(arrays):
    cfg = RenderConfig(width=16, height=12, spp=1)
    r = Renderer(arrays, cfg=cfg, device="cpu")
    params = CameraController().get_params(16, 12)
    for _ in range(3):
        r.step(params)
    img = r.image()
    assert img.dtype == np.uint8 and img.shape == (12, 16, 3)
    assert img.max() > 0
    np.testing.assert_array_equal(r.image(on_device=False), img)
    np.testing.assert_array_equal(
        img, jsnapshot.tonemap_accum(r.accum_host(), r.spp()))
    # The CUDA kernel takes no CPU accumulator: no fallback.
    with pytest.raises(ValueError, match="CUDA"):
        r.image(on_device=True)


def test_save_snapshot_writes_the_jax_packages_bytes(tmp_path, monkeypatch):
    accum = (np.random.RandomState(5).normal(0.5, 0.6, (6 * 4, 3))
             * 3).astype(np.float32)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    mine = snapshot.save_snapshot(accum, 6, 4, 3, 240.0, 0.25,
                                  out_dir=str(tmp_path / "port"))
    theirs = jsnapshot.save_snapshot(accum, 6, 4, 3, 240.0, 0.25,
                                     out_dir=str(tmp_path / "jax"))
    name = snapshot.snapshot_filename(3, 240.0, 0.25, when=1.7e9)
    assert name == jsnapshot.snapshot_filename(3, 240.0, 0.25, when=1.7e9)
    assert mine == str(tmp_path / "port" / name)
    assert theirs == str(tmp_path / "jax" / name)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data.startswith(b"P6\n6 4\n255\n") and len(data) == 11 + 72


@pytest.mark.cuda
def test_cuda_step_tiled_bit_identical_and_image_paths(arrays):
    """On the card: tiled waves run the wave kernel and equal step bit for
    bit; the three image paths agree."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")
    w, h = 96, 64
    cfg = RenderConfig(width=w, height=h, spp=1)
    params = CameraController().get_params(w, h)
    r1 = Renderer(arrays, cfg=cfg)
    r1.step(params)
    r2 = Renderer(arrays, cfg=cfg)
    before = (wave.wave_advance_cuda.launches, walk.quad_walk_cuda.launches)
    r2.step_tiled(params, 4)
    # One wave-kernel launch a tile, and no walk kernel.
    assert wave.wave_advance_cuda.launches - before[0] == 4
    assert walk.quad_walk_cuda.launches == before[1]
    assert r2.last_stats["iterations"] > 0
    assert torch.equal(r2.state.accum, r1.state.accum)
    for key in ("n_traced", "n_shadow", "rows_fetched"):
        assert int(r2.last_stats[key]) == int(r1.last_stats[key])
    img = r2.image()
    np.testing.assert_array_equal(r2.image(on_device=True), img)
    host = r2.image(on_device=False)
    # The kernel may differ from the host by 1 where p * 255 + 0.5 sits
    # on a float32 rounding boundary (chip_smoke.py MAX_BOUNDARY_SHARE).
    assert np.abs(host.astype(int) - img.astype(int)).max() <= 1
    assert (host != img).mean() <= 1e-5

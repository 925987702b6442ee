"""The port's display layer on the CPU: the host ARGB tonemap byte-equal
to the JAX package's (through the native library and through NumPy),
the drop-frame pipeline (after tests/test_display_cli.py), the scripted
input against the JAX one, the headless App and ProgressiveApp against
renderers driven by hand, the pacing of the progressive budget, SIGINT
and the windowed path under SDL's dummy driver.  No JAX program is
compiled."""

import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tryraytrace_tpu import native as jnative
from tryraytrace_tpu.camera.controller import CameraController as JCam
from tryraytrace_tpu.display import input as jinput
from tryraytrace_tpu.display import pipeline as jpipeline
from tryraytrace_tpu.engine import state as jstate

from tryraytrace_tpu_torch import native
from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.display import app as app_mod
from tryraytrace_tpu_torch.display.app import App, ProgressiveApp
from tryraytrace_tpu_torch.display.input import InputState, ScriptedInput
from tryraytrace_tpu_torch.display.pipeline import (DisplayPipeline,
                                                    tonemap_to_argb)
from tryraytrace_tpu_torch.engine.progressive import ProgressiveRenderer
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.io.snapshot import tonemap_accum
from tryraytrace_tpu_torch.scene.assets import checker_texture
from tryraytrace_tpu_torch.scene.cornell import create_cornell_box
from tryraytrace_tpu_torch.scene.model import flatten_scene

torch.set_num_threads(1)

W, H = 16, 12
SCRIPT = [{}, {}, {"keys": ["w"]}, {"save": True}]


@pytest.fixture(scope="module")
def arrays():
    return flatten_scene(create_cornell_box(mesh=None),
                         textures=[checker_texture(16)])


def _wait_frame(p: DisplayPipeline, timeout: float = 10.0) -> None:
    deadline = time.time() + timeout
    while not p.check_frame_ready():
        assert time.time() < deadline, "worker never produced a frame"
        time.sleep(0.005)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_tonemap_to_argb_matches_jax(route, monkeypatch):
    if route == "numpy":
        monkeypatch.setattr(native, "tonemap_argb", lambda *a: None)
        monkeypatch.setattr(jnative, "tonemap_argb", lambda *a: None)
    else:
        assert native.available(), "the native library did not build"
    rs = np.random.RandomState(7)
    for frame in (1, 3, 7):
        accum = rs.uniform(0.0, 4.0, size=(W * H * 5, 3)).astype(np.float32)
        accum[:4] = (0.0, 4.0, 1e-7)       # both clamps and a tiny value
        got = tonemap_to_argb(accum, frame)
        want = jpipeline.tonemap_to_argb(accum, frame)
        assert got.dtype == np.uint32 and got.shape == (accum.shape[0],)
        assert got.tobytes() == want.tobytes(), (route, frame)
        assert (got >> 24 == 0xFF).all()


def test_native_tonemap_matches_jax_and_numpy():
    accum = (np.random.RandomState(0).rand(97, 13, 3) * 8.0).astype(
        np.float32)
    got = native.tonemap(accum, 4)
    assert got.shape == accum.shape and got.dtype == np.uint8
    assert got.tobytes() == jnative.tonemap(accum, 4).tobytes()
    # powf vs np.power can differ by 1 at quantization boundaries.
    want = tonemap_accum(accum, 4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_pipeline_processes_frame():
    p = DisplayPipeline(4, 2)
    accum = np.full((8, 3), 2.0, np.float32)
    assert p.try_dispatch(accum, 2)
    _wait_frame(p)
    assert (p.pixel_buffer == tonemap_to_argb(accum, 2)).all()
    assert not p.busy() and not p.check_frame_ready()
    p.destroy()
    assert not p._thread.is_alive()


def test_pipeline_drop_frame_semantics():
    # Saturated with dispatches, the worker drops frames but neither
    # deadlocks nor corrupts (pipeline.cpp:122-137 drop-frame contract).
    p = DisplayPipeline(64, 64)
    accum = np.random.RandomState(2).rand(64 * 64, 3).astype(np.float32)
    accepted = sum(p.try_dispatch(accum, i + 1) for i in range(200))
    assert 1 <= accepted < 200
    deadline = time.time() + 10
    while p.busy():
        assert time.time() < deadline
        time.sleep(0.005)
    assert p.check_frame_ready() and not p.check_frame_ready()
    p.destroy()
    assert not p._thread.is_alive()


def test_pipeline_takes_host_arrays_only():
    """Only NumPy snapshots cross into the worker thread."""
    p = DisplayPipeline(2, 2)
    with pytest.raises(TypeError, match="NumPy"):
        p.try_dispatch(torch.zeros((4, 3)), 1)
    assert not p.busy()
    p.destroy()


def test_pipeline_dispatch_hammer():
    """Four producers hammer the single-slot mailbox while the main thread
    consumes, with a short switch interval: no deadlock, no crash, no
    miscomputed pixel."""
    p = DisplayPipeline(32, 32)
    n = 32 * 32
    errors = []
    valid = {int(tonemap_to_argb(np.full((1, 3), float(t + 1), np.float32),
                                 1)[0]) for t in range(4)}

    def producer(tid):
        try:
            for _ in range(300):
                p.try_dispatch(np.full((n, 3), float(tid + 1), np.float32), 1)
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        consumed = 0
        deadline = time.time() + 60
        while any(t.is_alive() for t in threads) and time.time() < deadline:
            if p.check_frame_ready():
                consumed += 1
                # A copy may mix two whole frames (the worker can swap
                # buffers while it is read, as the reference's display
                # can); a value outside the set would be a torn word or
                # wrong arithmetic.
                buf = p.pixel_buffer.copy()
                assert set(np.unique(buf).tolist()) <= valid
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        deadline = time.time() + 30
        while consumed == 0 and time.time() < deadline:
            if p.check_frame_ready():
                consumed += 1
                assert set(np.unique(p.pixel_buffer).tolist()) <= valid
            time.sleep(0.005)
    finally:
        sys.setswitchinterval(interval)
        p.destroy()
    assert not errors and consumed >= 1


def test_scripted_input_matches_jax():
    script = [{"keys": ["w", "d"]}, {"mouse": (900.0, -40.0)},
              {"save": True}, {"keys": ["q", "r", "t"]}, {}, {"quit": True}]
    ours, theirs = ScriptedInput(script), jinput.ScriptedInput(script)
    cam, jcam = CameraController(position=(1, 2, 3)), JCam(position=(1, 2, 3))
    for _ in range(len(script) + 1):
        a, b = ours.process_events(cam), theirs.process_events(jcam)
        assert isinstance(a, InputState)
        assert (a.quit, a.save_request, a.camera_moved) == (
            b.quit, b.save_request, b.camera_moved)
        for name in ("pos", "dir", "right", "up"):
            np.testing.assert_array_equal(getattr(cam, name),
                                          getattr(jcam, name))
        assert (cam.yaw, cam.pitch, cam.aperture, cam.focus_dist) == (
            jcam.yaw, jcam.pitch, jcam.aperture, jcam.focus_dist)
    assert a.quit  # script exhausted


def test_app_headless_matches_renderer_driven_by_hand(arrays, tmp_path):
    """Four ticks, a camera move on the third: the App's accumulator is
    the hand-driven Renderer's bit for bit, it writes a save and an exit
    snapshot, and its periodic .npz checkpoint loads in the JAX package."""
    cfg = RenderConfig(width=W, height=H, spp=1)
    ck = tmp_path / "auto.npz"
    app = App(arrays, cfg, input_source=ScriptedInput(SCRIPT),
              out_dir=str(tmp_path), checkpoint_every=2,
              checkpoint_path=str(ck), device="cpu")
    app.run()

    cam = CameraController()
    r = Renderer(arrays, cfg=cfg, device="cpu")
    r.step(cam.get_params(W, H))
    r.step(cam.get_params(W, H))
    r.reset()
    cam.update(1.0, {"w"})
    r.step(cam.get_params(W, H))
    after_move = r.state.accum.numpy().copy()
    r.step(cam.get_params(W, H))

    assert app.renderer.state.accum.numpy().tobytes() == (
        r.state.accum.numpy().tobytes())
    assert app.renderer.spp() == 2 and app.renderer.frame == r.frame == 3
    assert len(app.snapshots) == 2
    for path in app.snapshots:
        assert os.path.exists(path)
    # The save at tick 4 is the state after the move's first step.
    with open(app.snapshots[0], "rb") as f:
        data = f.read()
    want = tonemap_accum(after_move.reshape(H, W, 3), 1)
    assert data.endswith(want.tobytes())
    # The last checkpoint (frame 2 after the reset) in the JAX package.
    state, w, h, frame_seed, jcam = jstate.load_checkpoint(str(ck))
    assert (w, h, frame_seed, int(state.spp)) == (W, H, 2, 1)
    assert np.asarray(state.accum).tobytes() == after_move.tobytes()
    np.testing.assert_array_equal(jcam.pos, cam.pos)
    assert app.frames_displayed >= 1


def _spy_steps(app):
    """Record the rounds of every ProgressiveRenderer.step the app makes."""
    calls = []
    step = app.renderer.step

    def spy(params, iters):
        calls.append(int(iters))
        step(params, iters)

    app.renderer.step = spy
    return calls


def test_progressive_app_headless_resets_on_camera_move(arrays, tmp_path):
    cfg = RenderConfig(width=W, height=H)
    app = ProgressiveApp(arrays, cfg, input_source=ScriptedInput(SCRIPT),
                         out_dir=str(tmp_path), device="cpu")
    assert isinstance(app.renderer, ProgressiveRenderer)
    calls = _spy_steps(app)
    app.run()
    assert len(calls) == 4 and calls[0] == 16
    assert all(4 <= c <= 4096 for c in calls)
    # After the move only the last two ticks' rounds are in the wave.
    cam = CameraController()
    cam.update(1.0, {"w"})
    pr = ProgressiveRenderer(arrays, cfg=cfg, device="cpu")
    for c in calls[2:]:
        pr.step(cam.get_params(W, H), c)
    got, want = app.renderer.snapshot(), pr.snapshot()
    assert got[0].tobytes() == want[0].tobytes()
    assert (got[1] == want[1]).all() and got[1].min() >= 0
    assert app.renderer.rays_traced() == pr.rays_traced() > 0
    assert len(app.snapshots) == 2 and all(os.path.exists(s)
                                          for s in app.snapshots)


def test_progressive_app_save_before_any_step(arrays, tmp_path):
    app = ProgressiveApp(arrays, RenderConfig(width=W, height=H),
                         input_source=ScriptedInput([{"save": True}]),
                         out_dir=str(tmp_path), device="cpu")
    assert app.tick()
    app.pipeline.destroy()
    signal.signal(signal.SIGINT, app._prev_sigint)
    with open(app.snapshots[0], "rb") as f:
        data = f.read()
    assert data.startswith(b"P6\n16 12\n255\n")


def test_progressive_budget_counts_rounds_of_skipped_frames(arrays, tmp_path):
    """The reference's pacing fault (tryraytrace_tpu/display/app.py:217-225):
    after a frame the busy pipeline skipped, the JAX class divides the
    mean-spp growth over both frames by one frame's budget.  The port
    divides by every round run since the previous snapshot."""
    app = ProgressiveApp(arrays, RenderConfig(width=W, height=H),
                         input_source=ScriptedInput([{}] * 3),
                         out_dir=str(tmp_path), device="cpu")
    calls = _spy_steps(app)
    busy = iter([False, True, False])
    app.pipeline.busy = lambda: next(busy)
    means = []
    snapshot = app.renderer.snapshot

    def spy_snapshot():
        out = snapshot()
        means.append(float(out[1].mean()))
        return out

    app.renderer.snapshot = spy_snapshot
    for _ in range(3):
        assert app.tick()
    app.pipeline.destroy()
    signal.signal(signal.SIGINT, app._prev_sigint)
    assert len(calls) == 3 and len(means) == 2 and means[1] > means[0] > 0
    grown = means[1] - means[0]
    ours = int(np.clip(round((calls[1] + calls[2]) / grown), 4, 4096))
    reference = int(np.clip(round(calls[2] / grown), 4, 4096))
    assert app._iters == ours
    assert ours != reference


def test_sigint_ends_the_loop_with_an_exit_snapshot(arrays, tmp_path):
    class Interrupting:
        """Raises SIGINT in this process while the second tick reads input."""

        ticks = 0

        def process_events(self, cam):
            self.ticks += 1
            if self.ticks == 2:
                os.kill(os.getpid(), signal.SIGINT)
            return InputState()

    before = signal.getsignal(signal.SIGINT)
    app = App(arrays, RenderConfig(width=W, height=H, spp=1),
              input_source=Interrupting(), out_dir=str(tmp_path),
              device="cpu")
    app.run(max_frames=50)
    assert app.input.ticks == 2 and app.renderer.spp() == 1
    assert len(app.snapshots) == 1 and os.path.exists(app.snapshots[0])
    assert signal.getsignal(signal.SIGINT) is before


@pytest.mark.parametrize("cls", [App, ProgressiveApp])
def test_app_windowed_dummy_driver(cls, arrays, tmp_path, monkeypatch):
    """The pygame window (blit, flip, title HUD) under SDL's dummy video
    driver: the interactive frontend minus a monitor."""
    pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    logged = []
    monkeypatch.setattr(app_mod, "log_event",
                        lambda event, **kw: logged.append(event))
    app = cls(arrays, RenderConfig(width=24, height=16, spp=1),
              window=True, out_dir=str(tmp_path), device="cpu")
    app.run(max_frames=10)
    assert app.frames_displayed >= 1
    assert len(app.snapshots) == 1
    assert logged == ["frame"]  # the HUD of the tenth frame


@pytest.mark.cuda
def test_cuda_app_equals_cpu_app(arrays, tmp_path):
    """On the card: the App's accumulator after a scripted run is a
    hand-driven card Renderer's bit for bit, and the CPU App's bit for
    bit, with equal ray counts, at 64x48 (sides that are not powers of
    two: the camera rays divide by tensors on their device, so the
    card's division is the CPU's)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")
    w, h = 64, 48
    cfg = RenderConfig(width=w, height=h, spp=1)
    out, rays = {}, {}
    for run in ("cuda", "cpu"):
        app = App(arrays, cfg, input_source=ScriptedInput(SCRIPT),
                  out_dir=str(tmp_path / run), device=run)
        app.run()
        out[run] = app.renderer.state.accum.cpu().numpy()
        st = app.renderer.last_stats
        rays[run] = (int(st["n_traced"]), int(st["n_shadow"]))
    cam = CameraController()
    r = Renderer(arrays, cfg=cfg)
    r.step(cam.get_params(w, h))
    r.step(cam.get_params(w, h))
    r.reset()
    cam.update(1.0, {"w"})
    r.step(cam.get_params(w, h))
    r.step(cam.get_params(w, h))
    assert out["cuda"].tobytes() == r.state.accum.cpu().numpy().tobytes()
    assert rays["cuda"] == rays["cpu"]
    assert out["cuda"].mean() > 0
    assert out["cuda"].tobytes() == out["cpu"].tobytes()

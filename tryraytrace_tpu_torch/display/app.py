"""Application loop: the main.cpp analogue (the counterpart of
tryraytrace_tpu/display/app.py).

Reproduces the reference game loop's phase structure (main.cpp:152-223):
  A input -> (camera move? reset accumulation) ->
  B render (a batch step, or rounds of the progressive wave) ->
  C snapshot to the host + pipeline dispatch (drop-frame) ->
  D display when the worker has produced pixels.

The renderer runs on ``device`` (the card by default; ``"cpu"`` on
request).  Only host NumPy snapshots reach the display worker, which
tonemaps on the host as the JAX package does.  Headless by default (no
window; the pipeline still runs so the overlap behavior is exercised);
with pygame installed and ``window=True`` an interactive window opens
with the reference's key bindings.  SIGINT triggers save-and-exit like
main.cpp:32-39,224; the app must be built and run in the main thread,
where Python delivers signals.
"""

from __future__ import annotations

import os
import signal
import time

import numpy as np

from tryraytrace_tpu_torch.camera.controller import CameraController
from tryraytrace_tpu_torch.config import RenderConfig
from tryraytrace_tpu_torch.display.input import InputState, ScriptedInput
from tryraytrace_tpu_torch.display.pipeline import DisplayPipeline
from tryraytrace_tpu_torch.engine.renderer import Renderer
from tryraytrace_tpu_torch.engine.state import save_checkpoint
from tryraytrace_tpu_torch.io.snapshot import save_snapshot
from tryraytrace_tpu_torch.utils.logging import log_event


class App:
    def __init__(self, arrays, cfg: RenderConfig,
                 camera: CameraController | None = None,
                 input_source=None, window: bool = False,
                 out_dir: str = ".", checkpoint_every: int = 0,
                 checkpoint_path: str | None = None, device="cuda"):
        self.cfg = cfg
        self.renderer = self._make_renderer(arrays, cfg, device)
        self.camera = camera or CameraController()
        self.pipeline = DisplayPipeline(cfg.width, cfg.height)
        self.out_dir = out_dir
        self.frames_displayed = 0
        self.snapshots: list[str] = []
        self._quit = False
        # The reference loses all render state on any interruption; a
        # periodic raw-accumulator checkpoint (.npz) enables exact resume.
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path or f"{out_dir}/render_state.npz"
        if checkpoint_every:
            os.makedirs(os.path.dirname(self.checkpoint_path) or ".",
                        exist_ok=True)

        self._window = None
        if window:
            import pygame

            pygame.init()
            self._pg = pygame
            self._window = pygame.display.set_mode((cfg.width, cfg.height))
            pygame.display.set_caption("tpurt engine")
            from tryraytrace_tpu_torch.display.input import InputManager

            self.input = InputManager()
        else:
            self.input = input_source or ScriptedInput([])

        self._prev_sigint = signal.signal(signal.SIGINT, self._on_sigint)

    def _make_renderer(self, arrays, cfg, device):
        return Renderer(arrays, cfg=cfg, device=device)

    def _on_sigint(self, *_):
        self._quit = True  # main loop saves + exits (main.cpp:32-39)

    # -- one loop iteration -------------------------------------------
    def tick(self) -> bool:
        """Run one frame of the game loop; False when the app should
        exit."""
        r = self.renderer
        state: InputState = self.input.process_events(self.camera)

        if state.save_request:
            self.snapshots.append(self._save())
        if state.quit or self._quit:
            return False
        if state.camera_moved:
            r.reset()  # main.cpp:170-173

        params = self.camera.get_params(self.cfg.width, self.cfg.height)
        t0 = time.perf_counter()
        r.step(params)

        # Perf HUD every 10 frames (the reference only had the
        # window-title counter, main.cpp:213-218).  The sample count is
        # a host integer, so reading it does not wait for the device.
        if r.frame % 10 == 0:
            log_event("frame", n=r.frame, spp=r.spp(),
                      dispatch_ms=round((time.perf_counter() - t0) * 1e3, 2))

        # Snapshot + drop-frame dispatch (main.cpp:183-198).  The
        # device->host copy is the sync point (cudaDeviceSynchronize at
        # main.cpp:192), skipped when the worker is busy, since the
        # frame would be dropped anyway.
        if not self.pipeline.busy():
            self.pipeline.try_dispatch(r.accum_host(), max(r.spp(), 1))

        if (self.checkpoint_every and
                r.frame % self.checkpoint_every == 0):
            save_checkpoint(self.checkpoint_path, r.state, self.cfg.width,
                            self.cfg.height, camera=self.camera,
                            frame_seed=r.frame)

        self._present(r.frame)
        return True

    def _present(self, frame: int) -> None:
        """Phase D: count a frame the worker finished and, with a
        window, blit it and refresh the title HUD every 10 frames."""
        if not self.pipeline.check_frame_ready():
            return
        self.frames_displayed += 1
        if self._window is None:
            return
        buf = self.pipeline.pixel_buffer.reshape(self.cfg.height,
                                                 self.cfg.width)
        rgb = np.stack([(buf >> 16) & 0xFF, (buf >> 8) & 0xFF,
                        buf & 0xFF], axis=-1).astype(np.uint8)
        surf = self._pg.surfarray.make_surface(rgb.transpose(1, 0, 2))
        self._window.blit(surf, (0, 0))
        self._pg.display.flip()
        if frame % 10 == 0:  # title HUD (main.cpp:213-218)
            self._pg.display.set_caption(
                f"Frame: {frame} | Focus: {self.camera.focus_dist:.1f} | "
                f"Aperture: {self.camera.aperture:.1f}")

    def run(self, max_frames: int | None = None) -> None:
        """Tick until the input quits, SIGINT arrives or ``max_frames``
        ticks ran; then write the exit snapshot (main.cpp:224), stop the
        worker and give SIGINT back to its previous handler."""
        try:
            n = 0
            while self.tick():
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
            self.snapshots.append(self._save())
        finally:
            self.pipeline.destroy()
            if self._window is not None:
                self._pg.quit()
            signal.signal(signal.SIGINT, self._prev_sigint)

    def _save(self) -> str:
        r = self.renderer
        return save_snapshot(
            r.accum_host().reshape(-1, 3), self.cfg.width, self.cfg.height,
            max(r.spp(), 1), self.camera.get_focus_dist(),
            self.camera.get_aperture(), out_dir=self.out_dir)


class ProgressiveApp(App):
    """The game loop over the cross-frame progressive wave
    (engine/progressive.py): phase B advances the resident wave a
    budget of rounds instead of rendering an exact-spp batch frame, so
    no frame pays a wave drain.  Per-pixel sample counts diverge (cheap
    pixels converge faster); the display normalizes each pixel by its
    own completed-sample count.

    ``iters_per_frame`` is the budget in rounds (a lane's walk and one
    service each), not the JAX class's row-fetch iterations.
    ``0`` (default) adapts it so the MEAN per-pixel sample count
    advances ~1 per displayed frame -- the reference's
    1-spp-per-frame pacing (main.cpp:181) at whatever wall-clock the
    scene costs.  The growth is divided by every round run since the
    previous snapshot: frames the busy pipeline skipped count too (the
    JAX class divides by one frame's budget).
    """

    def __init__(self, arrays, cfg: RenderConfig,
                 camera: CameraController | None = None,
                 input_source=None, window: bool = False,
                 out_dir: str = ".", iters_per_frame: int = 0,
                 device="cuda"):
        super().__init__(arrays, cfg, camera=camera,
                         input_source=input_source, window=window,
                         out_dir=out_dir, device=device)
        self._iters = iters_per_frame
        self._adapt = iters_per_frame <= 0
        if self._adapt:
            self._iters = 16
        self._frame = 1
        self._last_mean = 0.0
        self._rounds = 0  # rounds run since the last snapshot

    def _make_renderer(self, arrays, cfg, device):
        from tryraytrace_tpu_torch.engine.progressive import ProgressiveRenderer

        return ProgressiveRenderer(arrays, cfg=cfg, device=device)

    def tick(self) -> bool:
        r = self.renderer
        state: InputState = self.input.process_events(self.camera)

        if state.save_request:
            self.snapshots.append(self._save())
        if state.quit or self._quit:
            return False
        if state.camera_moved:
            r.reset()  # main.cpp:170-173
            self._last_mean = 0.0
            self._rounds = 0

        params = self.camera.get_params(self.cfg.width, self.cfg.height)
        t0 = time.perf_counter()
        r.step(params, self._iters)
        self._rounds += self._iters
        self._frame += 1

        if self._frame % 10 == 0:
            log_event("frame", n=self._frame,
                      mean_spp=round(self._last_mean, 2),
                      iters=self._iters,
                      dispatch_ms=round((time.perf_counter() - t0) * 1e3,
                                        2))

        if not self.pipeline.busy():
            accum, counts = r.snapshot()
            mean = float(counts.mean())
            if self._adapt and mean > self._last_mean:
                # Aim the next frame's budget at +1 mean sample.
                per_round = (mean - self._last_mean) / self._rounds
                self._iters = int(np.clip(round(1.0 / per_round), 4, 4096))
            self._last_mean = mean
            self._rounds = 0
            img = accum / np.maximum(counts, 1)[:, None]
            self.pipeline.try_dispatch(img, 1)

        self._present(self._frame)
        return True

    def _save(self) -> str:
        acc, counts = self.renderer.snapshot()  # zeros before any step
        return save_snapshot(
            acc / np.maximum(counts, 1)[:, None], self.cfg.width,
            self.cfg.height, 1, self.camera.get_focus_dist(),
            self.camera.get_aperture(), out_dir=self.out_dir)

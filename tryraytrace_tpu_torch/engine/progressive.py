"""Cross-frame progressive renderer (the counterpart of
tryraytrace_tpu/engine/progressive.py).

The batch step renders exactly ``spp`` samples per pixel and drains its
wave every frame.  The reference application is an endless progressive
accumulator instead (main.cpp:149,170-181): one sample per pixel per
launch, reset on camera motion.  Here one regenerating wave
(engine/persistent.py ``Wave``) lives across display frames: a lane that
finishes its pixel's sample starts the next one at once, a frame is
"run the wave for N rounds, then snapshot", and with the default
unbounded cap no lane is ever DONE.

  - Per-pixel sample counts diverge (cheap pixels finish samples
    sooner), so ``snapshot`` returns the sums and each pixel's
    completed-sample count, and the caller normalizes per pixel.
  - A lane's draws are the batch engine's absolute (pixel, sample)
    streams (core/rng.py ``sample_seed`` with ``seed_spp``), so under a
    finite ``spp_cap`` the sums equal the batch ``Renderer``'s bit for
    bit (tests/test_torch_progressive.py).
  - The ray counters are int64 tensors: the JAX class counts in float32,
    which falls behind over a long session.
  - The port renders one wave, so ``cfg.max_wave_lanes`` is ignored, as
    in the batch engine (config.py).
"""

from __future__ import annotations

import numpy as np
import torch

from tryraytrace_tpu_torch.config import RenderConfig, check_supported
from tryraytrace_tpu_torch.engine.device_scene import upload_scene
from tryraytrace_tpu_torch.engine.persistent import Wave, build_inline_table
from tryraytrace_tpu_torch.engine.state import resolve_device

# Effectively unbounded per-pixel sample cap: lanes regenerate forever.
UNBOUNDED_SPP = 1 << 30


class ProgressiveRenderer:
    """Persistent-wave progressive renderer with cross-frame state, on
    ``device`` (the card by default; without one the constructor raises
    unless ``device="cpu"``).

    Typical use (the interactive loop)::

        pr = ProgressiveRenderer(arrays, cfg=cfg)
        while running:
            pr.step(cam.get_params(w, h), iters)
            accum, spp = pr.snapshot()      # per-pixel sums + counts
            display(accum / np.maximum(spp, 1)[:, None])
            if camera_moved:
                pr.reset()                  # main.cpp:170-173 parity

    ``spp_cap`` bounds samples per pixel (lanes retire at the cap); the
    default is unbounded.  ``frame_seed`` / ``seed_spp`` select the seed
    schedule ``1984 + frame_seed * seed_spp + sample``: the default
    (0, 1) gives lane sample s the reference's frame-s 1-spp stream
    (renderer.cu:326).
    """

    def __init__(self, arrays, cfg: RenderConfig | None = None,
                 width: int | None = None, height: int | None = None,
                 spp_cap: int = UNBOUNDED_SPP, frame_seed: int = 0,
                 seed_spp: int = 1, device="cuda"):
        cfg = cfg or RenderConfig()
        if (width is None) != (height is None):
            raise ValueError("width and height must be given together")
        self.cfg = cfg if width is None else cfg.with_size(width, height)
        self.width = self.cfg.width
        self.height = self.cfg.height
        self.spp_cap = int(spp_cap)
        self.frame_seed = int(frame_seed)
        self.seed_spp = int(seed_spp)
        if self.cfg.scheduler != "owner":
            raise ValueError(
                "ProgressiveRenderer supports the owner schedule only "
                f"(got {self.cfg.scheduler!r}); pool/quota claim pixels "
                "from a finite pool, which contradicts unbounded "
                "regeneration")
        if self.cfg.engine != "persistent":
            raise ValueError("ProgressiveRenderer wraps the persistent "
                             f"engine (cfg.engine={self.cfg.engine!r})")
        check_supported(self.cfg)
        self.device = resolve_device(device)
        self.scene, self.textures, self.bvh = upload_scene(
            arrays, leaf_size=self.cfg.bvh_leaf_size,
            method=self.cfg.bvh_method,
            quad_collapse=self.cfg.quad_collapse, device=self.device,
            leaf_fmt=self.cfg.leaf_isect)
        self.inline = build_inline_table(self.scene, self.textures)
        self._pixels = range(self.width * self.height)
        self.wave: Wave | None = None

    def reset(self) -> None:
        """Discard all accumulated state: the camera-moved reset
        (main.cpp:170-173 parity).  The next ``step`` starts a new wave
        with its own camera, so no frame after a reset mixes rays from
        the old pose."""
        self.wave = None

    def step(self, cam_params, iters: int) -> None:
        """Advance the wave by ``iters`` rounds, or until every lane is
        DONE (finite cap only).  ``cam_params`` must be constant since
        the last ``reset()``.

        A round is a lane's walk to its end plus one service (on a card
        the whole call is one launch of the wave kernel, ops/wave.py);
        the JAX class's ``iters`` counts while-loop
        iterations of one row fetch per lane.  So the per-pixel counts
        after k calls differ between the two packages; the sums under a
        finite cap, once ``done()``, do not."""
        if self.wave is None:
            self.wave = Wave(self.scene, self.inline, cam_params,
                             self.frame_seed, self.width, self.height,
                             self.cfg, self._pixels, self.spp_cap,
                             self.seed_spp)
        self.wave.advance(int(iters))

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (accum [n, 3] float32, completed-sample counts [n] int32)
        on the host.  ``accum`` is the sum over completed samples;
        normalize per pixel by ``np.maximum(counts, 1)``.  The wave is
        left as it was."""
        n = self.width * self.height
        if self.wave is None:
            return np.zeros((n, 3), np.float32), np.zeros((n,), np.int32)
        out, count = self.wave.read()
        return out.cpu().numpy(), count.to(torch.int32).cpu().numpy()

    def rays_traced(self) -> int:
        """Path segments + shadow rays traced since ``reset()``, exact."""
        if self.wave is None:
            return 0
        return int(self.wave.n_traced + self.wave.n_shadow)

    def done(self) -> bool:
        """True when every lane retired (finite ``spp_cap`` only); as in
        the JAX class, also before the first ``step``."""
        return self.wave is None or self.wave.done

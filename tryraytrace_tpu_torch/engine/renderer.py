"""High-level progressive renderer (the counterpart of
tryraytrace_tpu/engine/renderer.py).

  - construction = scene upload (BVH build, table packing, upload to
    ``device``) and the unified inline table;
  - ``step(cam)`` = one progressive pass: render a frame's samples (the
    round loop; its walks run in the CUDA walk kernel on a card, in the
    kernel's plain version on the CPU) and add them to the accumulator,
    which stays on the device;
  - ``reset()`` on camera move;
  - ``image()`` tonemaps on the device (the CUDA kernel on a card, its
    plain version on the CPU) and copies only the uint8 pixels out.
"""

from __future__ import annotations

import numpy as np
import torch

from tryraytrace_tpu_torch.config import (DEFAULT_CONFIG, RenderConfig,
                                          check_supported)
from tryraytrace_tpu_torch.engine.device_scene import upload_scene
from tryraytrace_tpu_torch.engine.persistent import (build_inline_table,
                                                     render_frame_persistent)
from tryraytrace_tpu_torch.engine.state import RenderState, resolve_device
from tryraytrace_tpu_torch.ops.tonemap import tonemap
from tryraytrace_tpu_torch.scene.model import Scene, SceneArrays, flatten_scene


class Renderer:
    """Progressive path tracer bound to one scene, resolution and device
    (the card by default; without one the constructor raises unless
    ``device="cpu"``)."""

    def __init__(self, scene, width: int | None = None,
                 height: int | None = None,
                 cfg: RenderConfig = DEFAULT_CONFIG,
                 textures=None, device="cuda"):
        check_supported(cfg)
        if isinstance(scene, Scene):
            arrays = flatten_scene(scene, textures=textures,
                                   light_scan_threshold=cfg.light_scan_threshold)
        elif isinstance(scene, SceneArrays):
            arrays = scene
        else:
            raise TypeError(f"unsupported scene type {type(scene)}")
        if (width is None) != (height is None):
            raise ValueError("width and height must be given together")
        self.cfg = cfg if width is None else cfg.with_size(width, height)
        self.width = self.cfg.width
        self.height = self.cfg.height
        self.device = resolve_device(device)
        self.scene, self.textures, self.bvh = upload_scene(
            arrays, leaf_size=self.cfg.bvh_leaf_size,
            method=self.cfg.bvh_method,
            quad_collapse=self.cfg.quad_collapse, device=self.device)
        self.inline = build_inline_table(self.scene, self.textures)
        self.state = RenderState.zeros(self.width * self.height, self.device)
        self.frame = 1  # gpu_frame counter parity (main.cpp:149)
        self._step_spp = None
        # The last step's ray counts, rounds and rows fetched
        # (render_frame_persistent's stats).
        self.last_stats = None

    def step(self, cam, spp: int | None = None) -> None:
        """One progressive pass (launch_render_kernel analogue)."""
        spp = self.cfg.spp if spp is None else spp
        # The seed schedule 1984 + frame*spp + sample is collision-free
        # only at constant spp.
        if self._step_spp is not None and spp != self._step_spp:
            raise ValueError(
                f"spp changed {self._step_spp} -> {spp} mid-accumulation; "
                "call reset() first (RNG streams would alias)")
        self._step_spp = spp
        acc, self.last_stats = render_frame_persistent(
            self.scene, self.inline, cam, self.frame, self.width,
            self.height, self.cfg, spp)
        self.state = RenderState(self.state.accum + acc, self.state.spp + spp)
        self.frame += 1

    def reset(self) -> None:
        """Camera moved: restart accumulation (main.cpp:170-173)."""
        self.state = self.state.reset()
        self.frame = 1
        self._step_spp = None

    def accum_host(self) -> np.ndarray:
        """Device -> host accumulator read, [H, W, 3] f32."""
        return self.state.accum.cpu().numpy().reshape(self.height,
                                                      self.width, 3)

    def spp(self) -> int:
        return self.state.spp

    def image(self) -> np.ndarray:
        """Tonemapped uint8 [H, W, 3] of the current accumulation,
        tonemapped on the accumulator's device."""
        img = tonemap(self.state.accum, max(self.state.spp, 1))
        return img.cpu().numpy().reshape(self.height, self.width, 3)

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

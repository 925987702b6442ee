"""High-level progressive renderer (the counterpart of
tryraytrace_tpu/engine/renderer.py).

  - construction = scene upload (BVH build, table packing, upload to
    ``device``) and what the engine reads besides it (the persistent
    engine's unified inline table, the bounce engine's textures and
    tables);
  - ``step(cam)`` = one progressive pass: render a frame's samples with
    the engine ``cfg.engine`` names (the persistent engine's round loop,
    or the bounce engine's lockstep bounces; the walks run in the CUDA
    kernels on a card, in their plain versions on the CPU) and add them
    to the accumulator, which stays on the device;
    ``step_tiled(cam, tiles)`` the same pass over pixel strips,
    bit-identical;
  - ``reset()`` on camera move; ``refit(scene)`` for moved geometry
    (a BVH refit instead of a rebuild, then a reset);
  - ``image()`` tonemaps on the device (the CUDA kernel on a card, its
    plain version on the CPU) and copies only the uint8 pixels out;
    ``image(on_device=False)`` tonemaps on the host.

A checkpoint of ``state`` and ``frame`` is engine/state.py's
``save_checkpoint`` / ``load_checkpoint``.
"""

from __future__ import annotations

import numpy as np
import torch

from tryraytrace_tpu_torch.config import (DEFAULT_CONFIG, RenderConfig,
                                          check_supported)
from tryraytrace_tpu_torch.engine.device_scene import (refit_scene,
                                                       upload_scene)
from tryraytrace_tpu_torch.engine.state import RenderState, resolve_device
from tryraytrace_tpu_torch.engine.wavefront import engine_tables, render_frame
from tryraytrace_tpu_torch.io.snapshot import tonemap_accum
from tryraytrace_tpu_torch.ops.tonemap import tonemap, tonemap_cuda
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
            quad_collapse=self.cfg.quad_collapse, device=self.device,
            leaf_fmt=self.cfg.leaf_isect)
        self.inline, self.device_textures, self.bounce_tables = (
            engine_tables(self.scene, self.textures, self.cfg))
        self.state = RenderState.zeros(self.width * self.height, self.device)
        self.frame = 1  # gpu_frame counter parity (main.cpp:149)
        self._step_spp = None
        # The last step's ray counts, rounds (or bounces) and rows fetched
        # (wavefront.render_frame's stats).
        self.last_stats = None

    def _render(self, cam, spp: int, pixels=None):
        return render_frame(self.scene, self.inline, self.device_textures,
                            cam, self.frame, self.width, self.height,
                            self.cfg, spp, pixels,
                            tables=self.bounce_tables)

    def step(self, cam, spp: int | None = None) -> None:
        """One progressive pass (launch_render_kernel analogue)."""
        spp = self._begin_step(spp)
        acc, self.last_stats = self._render(cam, spp)
        self._accumulate(acc, spp)

    def step_tiled(self, cam, tiles: int, spp: int | None = None) -> None:
        """One progressive pass rendered as ``tiles`` waves over pixel
        strips of ``ceil(n / tiles)`` pixels, one after another (tiles
        clamped to [1, n]): each wave holds only its strip's lanes.

        Bit-identical to ``step``: a lane's draws are keyed by absolute
        (pixel, sample), its arithmetic is elementwise and its pixel's
        sum is added in sample order, so which wave rendered a pixel
        cannot change its sum (tests/test_torch_state.py).
        ``last_stats`` holds the strips' totals."""
        spp = self._begin_step(spp)
        n = self.width * self.height
        span = -(-n // max(1, min(int(tiles), n)))
        parts, stats = [], []
        for start in range(0, n, span):
            part, st = self._render(cam, spp, range(start,
                                                    min(start + span, n)))
            parts.append(part)
            stats.append(st)
        self.last_stats = {key: sum(st[key] for st in stats)
                           for key in stats[0]}
        self._accumulate(torch.cat(parts), spp)

    def _begin_step(self, spp: int | None) -> int:
        spp = self.cfg.spp if spp is None else spp
        # The seed schedule 1984 + frame*spp + sample is collision-free
        # only at constant spp.
        if self._step_spp is not None and spp != self._step_spp:
            raise ValueError(
                f"spp changed {self._step_spp} -> {spp} mid-accumulation; "
                "call reset() first (RNG streams would alias)")
        self._step_spp = spp
        return spp

    def _accumulate(self, acc: torch.Tensor, spp: int) -> None:
        self.state = RenderState(self.state.accum + acc, self.state.spp + spp)
        self.frame += 1

    def reset(self) -> None:
        """Camera moved: restart accumulation (main.cpp:170-173)."""
        self.state = self.state.reset()
        self.frame = 1
        self._step_spp = None

    def refit(self, scene, textures=None) -> None:
        """Moved geometry: re-upload the scene's vertices and materials
        (same topology and light set) through a BVH refit instead of a
        rebuild (the threaded table repacked with the quad table),
        rebuild the unified table and its walk-order copy from the
        repacked rows, and restart accumulation.  Raises ValueError
        when the triangle count differs from the upload's."""
        if isinstance(scene, Scene):
            arrays = flatten_scene(
                scene, textures=textures,
                light_scan_threshold=self.cfg.light_scan_threshold)
        else:
            arrays = scene
        # Triangles in the original order: the SBVH's slots may
        # reference a triangle twice.
        n_orig = (int(self.bvh.perm.max()) + 1 if self.bvh.perm.size
                  else int(self.scene.trimat.shape[0]))
        if arrays.num_objects != n_orig:
            raise ValueError(
                f"refit needs identical topology: {arrays.num_objects} "
                f"objects vs {n_orig} at upload (build a new Renderer "
                "instead)")
        self.scene, self.bvh = refit_scene(self.scene, self.bvh, arrays)
        self.inline, self.device_textures, self.bounce_tables = (
            engine_tables(self.scene, self.textures, self.cfg))
        self.reset()

    def accum_host(self) -> np.ndarray:
        """Device -> host accumulator read, [H, W, 3] f32."""
        return self.state.accum.cpu().numpy().reshape(self.height,
                                                      self.width, 3)

    def spp(self) -> int:
        return self.state.spp

    def image(self, on_device: bool | None = None) -> np.ndarray:
        """Tonemapped uint8 [H, W, 3] of the current accumulation.

        ``on_device=True`` runs the CUDA tonemap kernel, so only the
        uint8 pixels cross to the host (it raises for an accumulator on
        the CPU); ``False`` copies the accumulator out and runs the
        host ``tonemap_accum``; ``None`` (the default) tonemaps on the
        accumulator's device: the kernel on a card, its plain version
        on the CPU."""
        spp = max(self.state.spp, 1)
        if on_device is False:
            return tonemap_accum(self.accum_host(), spp)
        accum = self.state.accum
        img = tonemap_cuda(accum, spp) if on_device else tonemap(accum, spp)
        return img.cpu().numpy().reshape(self.height, self.width, 3)

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

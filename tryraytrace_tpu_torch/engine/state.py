"""Progressive render state: the per-pixel radiance sum and its sample
count (the counterpart of tryraytrace_tpu/engine/state.py, without
checkpoints).  The sum stays on the render device; the count is a
host integer, so reading it never waits for the device."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RenderState:
    accum: torch.Tensor  # [N, 3] f32 radiance sum
    spp: int             # samples accumulated per pixel

    @staticmethod
    def zeros(n: int, device="cpu") -> "RenderState":
        return RenderState(torch.zeros((n, 3), device=device), 0)

    def reset(self) -> "RenderState":
        """Camera moved -> discard accumulation (main.cpp:170-173)."""
        return RenderState(torch.zeros_like(self.accum), 0)

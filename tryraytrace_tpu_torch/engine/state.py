"""Progressive render state: the per-pixel radiance sum and its sample
count (the counterpart of tryraytrace_tpu/engine/state.py, without
checkpoints).  The sum stays on the render device; the count is a
host integer, so reading it never waits for the device."""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device.  The port's entry points run on the
    card unless the caller asks for the CPU: a CUDA device that is not
    there raises, nothing moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but no CUDA device is "
            'present; pass device="cpu" to run on the CPU')
    return dev


@dataclasses.dataclass
class RenderState:
    accum: torch.Tensor  # [N, 3] f32 radiance sum
    spp: int             # samples accumulated per pixel

    @staticmethod
    def zeros(n: int, device="cuda") -> "RenderState":
        """An empty accumulation on ``device`` (the card by default;
        raises without one unless ``device="cpu"``)."""
        return RenderState(
            torch.zeros((n, 3), device=resolve_device(device)), 0)

    def reset(self) -> "RenderState":
        """Camera moved -> discard accumulation (main.cpp:170-173)."""
        return RenderState(torch.zeros_like(self.accum), 0)

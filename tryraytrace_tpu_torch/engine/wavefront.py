"""Sample sanitation, the one piece of tryraytrace_tpu/engine/
wavefront.py on the port's path (the bounce engine is not ported)."""

from __future__ import annotations

import torch

from tryraytrace_tpu_torch.config import RenderConfig


def _sanitize(rad, cfg: RenderConfig):
    """Sample sanitation before accumulation (renderer.cu:737-756):
    NaN/Inf drops the whole sample, negatives clamp to 0, luminance
    fireflies rescale to ``cfg.firefly_clamp``."""
    bad = (torch.isnan(rad) | torch.isinf(rad)).any(dim=-1)
    rad = torch.where(bad[..., None], 0.0, rad)
    rad = torch.clamp(rad, min=0.0)
    if cfg.clamp_fireflies:
        lum = rad[..., 0] * 0.21 + rad[..., 1] * 0.71 + rad[..., 2] * 0.07
        over = lum > cfg.firefly_clamp
        # A tensor division: torch computes ``c / t`` as
        # ``reciprocal(t) * c``, which rounds twice.
        clamp = torch.full_like(lum, cfg.firefly_clamp)
        scale = torch.where(over, clamp / torch.where(over, lum, 1.0), 1.0)
        rad = rad * scale[..., None]
    return rad

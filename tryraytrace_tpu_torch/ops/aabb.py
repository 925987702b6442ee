"""Slab-method ray/AABB test on torch tensors (reference aabb.h:49-69).

The counterpart of tryraytrace_tpu/ops/aabb.py.  Boxes are float32
rows [..., 6] (min xyz, max xyz); leading axes broadcast, so the quad
walk tests a row's four child boxes as one [w, 4, 6] call.
"""

from __future__ import annotations

import torch


def aabb_hit(bounds, r_o, r_inv_d, t_min, t_max) -> torch.Tensor:
    """bounds [..., 6], r_o / r_inv_d [..., 3], t_min / t_max scalar or
    [...]; true where ``tmax >= tmin and tmax > t_min and tmin < t_max``."""
    t1 = (bounds[..., :3] - r_o) * r_inv_d
    t2 = (bounds[..., 3:] - r_o) * r_inv_d
    lo = torch.minimum(t1, t2).amax(dim=-1)
    hi = torch.maximum(t1, t2).amin(dim=-1)
    return (hi >= lo) & (hi > t_min) & (lo < t_max)

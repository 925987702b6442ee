"""Primary ray generation: tent-filter AA + thin-lens depth of field.

The counterpart of tryraytrace_tpu/engine/camera_rays.py (reference
renderer.cu:331-356).  Pixel ``i`` is the reference's accumulation
index ``(height - y - 1) * width + x`` and also the RNG stream; the
four camera draws use the fixed slots 0..3.
"""

from __future__ import annotations

import numpy as np
import torch

from tryraytrace_tpu_torch.core import rng, vec

TWO_PI = float(np.float32(2.0 * np.pi))


def generate_rays(cam, width: int, height: int, seed, pixel_idx):
    """Primary rays for pixel indices ``pixel_idx`` [N] -> (o, d) [N, 3].

    ``cam`` is a CameraParams, moved to the pixels' device here when it
    is not there (CameraParams.to); ``seed`` is the per-lane sample
    seed, int64 in [0, 2**32)."""
    i = pixel_idx
    cam = cam.to(i.device)
    x = (i % width).to(torch.float32)
    row = i // width
    y = (height - 1 - row).to(torch.float32)  # buffer row -> "up" index

    slots = torch.arange(4, device=i.device)
    u = rng.uniform(seed[:, None], i[:, None], slots)
    u0, u1, u2, u3 = u.unbind(1)

    # Tent-filter anti-aliasing jitter (renderer.cu:331-334).
    r1 = 2.0 * u0
    r2 = 2.0 * u1
    dx = torch.where(r1 < 1.0, vec.sqrt(r1) - 1.0,
                     1.0 - vec.sqrt(torch.clamp(2.0 - r1, min=0.0)))
    dy = torch.where(r2 < 1.0, vec.sqrt(r2) - 1.0,
                     1.0 - vec.sqrt(torch.clamp(2.0 - r2, min=0.0)))

    # Ideal pinhole direction (renderer.cu:337-338).  The sides are
    # divided as float32 tensors on the lanes' device: torch's CUDA
    # division by a Python number (or a CPU scalar tensor) multiplies
    # by its rounded reciprocal, which the CPU's division does not.
    sx = ((x + 0.5 + dx) / vec.scalar(width, x) - 0.5)[..., None]
    sy = ((y + 0.5 + dy) / vec.scalar(height, y) - 0.5)[..., None]
    dir_pinhole = vec.norm(cam.cx * sx + cam.cy * sy + cam.dir)

    # Thin-lens sampling (renderer.cu:341-348); a zero lens radius
    # gives an exactly zero offset.
    lr = cam.lens_radius * vec.sqrt(u2)
    ltheta = TWO_PI * u3
    u_axis = vec.norm(cam.cx)
    v_axis = vec.norm(cam.cy)
    lens_offset = (u_axis * (lr * vec.cos(ltheta))[..., None]
                   + v_axis * (lr * vec.sin(ltheta))[..., None])

    # Focus-plane construction (renderer.cu:350-356).
    p_focus = cam.pos + dir_pinhole * cam.focus_dist
    r_o = cam.pos + lens_offset
    r_d = vec.norm(p_focus - r_o)
    return r_o, r_d

"""float3 helpers on torch tensors of shape [..., 3].

The counterpart of tryraytrace_tpu/core/vec.py.  Every reduction over
the three components is written out left to right, ``(x0 + x1) + x2``,
the order the JAX engine and the NumPy oracle use, so results agree
to the bit wherever the elementwise ops do.  All math is float32.

Two torch habits would break that agreement, and the port avoids both:
``sqrt``, ``pow``, ``cos`` and ``sin`` here are evaluated in float64
and rounded once to float32 (torch's vectorized CPU float32 versions
are off by an ulp in 0.6% to 5% of inputs, and the card's differ
again), which gives the correctly rounded result on every device; and
a Python constant over a tensor is written as a tensor division,
because torch evaluates ``c / t`` as ``reciprocal(t) * c``, which
rounds twice.  A tensor over a Python number is divided by a tensor on
its own device (``scalar``): torch's CUDA division by a number, or by a
0-dim CPU tensor, multiplies by the float32 reciprocal instead.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: the float64 root rounded
    to float32 equals the IEEE float32 root."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """float32 ``x ** e`` through float64."""
    return torch.pow(x.to(torch.float64), float(e)).to(torch.float32)


def cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine through float64."""
    return torch.cos(x.to(torch.float64)).to(torch.float32)


def sin(x: torch.Tensor) -> torch.Tensor:
    """float32 sine through float64."""
    return torch.sin(x.to(torch.float64)).to(torch.float32)


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype on ``like``'s
    device, for ``t / scalar(c, t)`` (module docstring)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (common.h:88-90)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def norm(a: torch.Tensor) -> torch.Tensor:
    """Normalize over the last axis; zero vectors pass through
    (Vec::norm's ``if (len > 0)`` guard, common.h:70-76).  Multiplies
    by the reciprocal length, as the JAX helper does."""
    length = sqrt(dot(a, a))[..., None]
    pos = length > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, length, 1.0), 1.0)
    return a * inv


def length(a: torch.Tensor) -> torch.Tensor:
    return sqrt(dot(a, a))


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """Sign-preserving reciprocal of a ray direction: |x| < 1e-8 ->
    +-1e20, else 1/x (reference renderer.cu:371-373)."""
    tiny = torch.abs(d) < 1e-8
    big = torch.where(d >= 0, 1e20, -1e20)
    return torch.where(tiny, big, 1.0 / torch.where(tiny, 1.0, d))

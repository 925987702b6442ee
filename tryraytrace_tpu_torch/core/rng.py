"""Counter-based random numbers on torch tensors.

The same generator as tryraytrace_tpu/core/rng.py: every draw is a
pure function ``u = U(seed, stream, draw_id)`` of the sample seed, the
pixel and a fixed per-bounce draw slot, hashed with the PCG output
permutation.  The port computes the identical uint32 values, so its
images are bit-comparable with the JAX engine and the NumPy oracle.
No ``torch.Generator`` is involved.

torch has no uint32 add or right shift on the CPU, so the hash runs in
int64 and keeps the low 32 bits after every add and multiply.  Every
intermediate stays below 2**63: a product is at most
(2**32 - 1) * 747796405 < 2**62.
"""

from __future__ import annotations

import torch

CAMERA_DRAWS = 4
DRAWS_PER_BOUNCE = 8
SLOT_RR = 0
SLOT_BRANCH = 1
SLOT_DIR_R1 = 2
SLOT_DIR_R2 = 3
SLOT_LIGHT_PICK = 4
SLOT_LIGHT_R1 = 5
SLOT_LIGHT_R2 = 6

MASK32 = 0xFFFFFFFF
_INV_2_24 = 1.0 / 16777216.0  # exact in float32


def _u32(x):
    """``x`` modulo 2**32: an int64 tensor for a tensor, else an int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def pcg(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation hash of uint32 values held in int64."""
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def hash3(a, b, c) -> torch.Tensor:
    """Mix three uint32 streams into one hash value (int64 in [0, 2**32))."""
    a, b, c = _u32(a), _u32(b), _u32(c)
    return pcg((a + pcg((b + pcg(c)) & MASK32)) & MASK32)


def uniform(seed, stream, draw_id) -> torch.Tensor:
    """U(seed, stream, draw_id) -> float32 in [0, 1) from the top 24
    bits of the hash (exact in the float32 mantissa)."""
    bits = hash3(seed, stream, draw_id)
    return (bits >> 8).to(torch.float32) * _INV_2_24


def sample_seed(frame_seed, spp: int, sample):
    """The seed schedule ``1984 + frame*spp + sample`` mod 2**32 shared
    by every engine and the oracle.  Tensor inputs give an int64
    tensor, Python ints a Python int."""
    if isinstance(frame_seed, torch.Tensor) or isinstance(sample,
                                                          torch.Tensor):
        return (1984 + ((_u32(frame_seed) * spp) & MASK32)
                + _u32(sample)) & MASK32
    return (1984 + frame_seed * spp + sample) & MASK32

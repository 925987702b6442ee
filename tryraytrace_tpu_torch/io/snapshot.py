"""Host-side tonemap: accumulator -> uint8 image (NumPy).

A jax-free copy of ``tonemap_accum`` in tryraytrace_tpu/io/snapshot.py
(reference image_io.cpp:53-68): average by the sample count, clamp,
gamma 1/2.2, ``* 255 + 0.5``, truncate.  The device path is
ops/tonemap.py.
"""

from __future__ import annotations

import numpy as np

GAMMA_EXP = np.float32(1.0 / 2.2)


def tonemap_accum(h_accum: np.ndarray, frame: int) -> np.ndarray:
    """Average by sample count + gamma quantize -> uint8 [..., 3]."""
    avg = np.asarray(h_accum, dtype=np.float32) * np.float32(1.0 / max(frame, 1))
    x = np.clip(avg, 0.0, 1.0)
    return (np.power(x, GAMMA_EXP) * 255.0 + 0.5).astype(np.int32).astype(np.uint8)

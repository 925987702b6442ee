"""Snapshot writer: accumulator -> tonemapped P6 file (NumPy).

A jax-free copy of tryraytrace_tpu/io/snapshot.py (reference
image_io.cpp:17-92): ``tonemap_accum`` averages by the sample count,
clamps, applies gamma 1/2.2, ``* 255 + 0.5`` and truncates;
``save_snapshot`` writes the result under ``logs/`` with a
``YYYY-MM-DD_HH-MM-SS_Frame<N>_F<focus>_A<aperture>.ppm`` name.  The
device tonemap is ops/tonemap.py.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from tryraytrace_tpu_torch.io.ppm import save_ppm

GAMMA_EXP = np.float32(1.0 / 2.2)


def to_int(x: np.ndarray) -> np.ndarray:
    """Linear float32 -> gamma-corrected 0..255 int32 (the reference's
    toInt, common.h:126-128; core/vec.py ``to_int`` of the JAX
    package)."""
    return (np.power(np.clip(x, 0.0, 1.0), GAMMA_EXP) * 255.0
            + 0.5).astype(np.int32)


def tonemap_accum(h_accum: np.ndarray, frame: int) -> np.ndarray:
    """Average by sample count + gamma quantize -> uint8 [..., 3]."""
    avg = np.asarray(h_accum, dtype=np.float32) * np.float32(1.0 / max(frame, 1))
    return to_int(avg).astype(np.uint8)


def snapshot_filename(frame: int, focus_dist: float, aperture: float,
                      when: float | None = None) -> str:
    t = time.localtime(when if when is not None else time.time())
    time_str = time.strftime("%Y-%m-%d_%H-%M-%S", t)
    # Format string parity with image_io.cpp:38-39 (focus %.1f, aperture %.2f).
    return f"logs/{time_str}_Frame{frame}_F{focus_dist:.1f}_A{aperture:.2f}.ppm"


def save_snapshot(h_accum: np.ndarray, w: int, h: int, frame: int,
                  focus_dist: float, aperture: float,
                  out_dir: str = ".") -> str:
    """Write the tonemapped accumulator to logs/; returns the path."""
    img = tonemap_accum(np.asarray(h_accum).reshape(h, w, 3), frame)
    rel = snapshot_filename(frame, focus_dist, aperture)
    path = os.path.join(out_dir, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_ppm(path, img)
    print(f"[IO] Snapshot saved: {path}", file=sys.stderr)
    return path

"""Background display pipeline: accumulator snapshot -> tonemap -> pixels
(the counterpart of tryraytrace_tpu/display/pipeline.py).

Parity target: the reference's Pipeline (pipeline.h:12-48,
pipeline.cpp:13-164): one worker thread consuming frame snapshots with
*drop-frame* semantics -- if the worker is still busy when the next
frame is dispatched, that frame is simply never displayed
(pipeline.cpp:122-137), so the render loop never stalls on post-
processing.

The render loop copies the accumulator to the host (``accum_host`` /
``snapshot``, the device->host sync point) and hands the worker that
NumPy array; no CUDA tensor ever crosses into the worker thread.  The
worker tonemaps on the host, as the JAX package does: the native C++
loop when the library is built, NumPy otherwise.  Synchronization is a
single-slot mailbox guarded by a mutex+condvar, mirroring the
reference's worker_busy / frame_ready flags; the worker writes a back
buffer and swaps it in under the lock, so a reader never sees a torn
frame.
"""

from __future__ import annotations

import threading

import numpy as np

from tryraytrace_tpu_torch import native
from tryraytrace_tpu_torch.io.snapshot import to_int


def tonemap_to_argb(accum: np.ndarray, frame: int) -> np.ndarray:
    """Average + gamma + pack to 0xAARRGGBB uint32 [n] (pipeline.cpp:59-71)."""
    out = native.tonemap_argb(accum, frame)
    if out is not None:
        return out
    avg = np.asarray(accum, np.float32).reshape(-1, 3) * np.float32(
        1.0 / max(frame, 1))
    rgb = to_int(avg).astype(np.uint32)
    return ((np.uint32(255) << 24) | (rgb[:, 0] << 16)
            | (rgb[:, 1] << 8) | rgb[:, 2])


class DisplayPipeline:
    """Single-slot worker pipeline with drop-frame dispatch."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.pixel_buffer = np.zeros(width * height, np.uint32)
        self._back_buffer = np.zeros(width * height, np.uint32)
        self._mtx = threading.Condition()
        self._task = None          # (accum snapshot, frame) or None
        self._worker_busy = False
        self._frame_ready = False
        self._quit = False
        self._thread = threading.Thread(target=self._worker_loop,
                                        daemon=True)
        self._thread.start()

    # -- producer side (render loop) ------------------------------------
    def try_dispatch(self, accum_snapshot: np.ndarray, frame: int) -> bool:
        """Hand a host frame to the worker; False = worker busy, frame
        dropped (pipeline_try_dispatch, pipeline.cpp:122-137)."""
        if not isinstance(accum_snapshot, np.ndarray):
            raise TypeError("the display worker takes a NumPy snapshot, "
                            f"not {type(accum_snapshot).__name__}")
        with self._mtx:
            if self._worker_busy:
                return False
            self._task = (accum_snapshot, frame)
            self._worker_busy = True
            self._mtx.notify()
            return True

    def busy(self) -> bool:
        """True while the worker is processing a frame -- callers can
        skip the device snapshot for frames that would be dropped
        anyway."""
        with self._mtx:
            return self._worker_busy

    def check_frame_ready(self) -> bool:
        """True exactly once per completed frame (pipeline.cpp:141-151)."""
        with self._mtx:
            if self._frame_ready:
                self._frame_ready = False
                return True
            return False

    def destroy(self) -> None:
        """Stop and join the worker (pipeline_destroy, pipeline.cpp:155-164)."""
        with self._mtx:
            self._quit = True
            self._mtx.notify()
        self._thread.join(timeout=5.0)

    # -- worker side ------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            with self._mtx:
                self._mtx.wait_for(lambda: self._quit or self._worker_busy)
                if self._quit:
                    return
                accum, frame = self._task
                self._task = None
            # Out of the lock: the compute phase (pipeline.cpp:40-71).
            self._back_buffer[:] = tonemap_to_argb(accum, frame)
            with self._mtx:
                self.pixel_buffer, self._back_buffer = (
                    self._back_buffer, self.pixel_buffer)
                self._frame_ready = True
                self._worker_busy = False

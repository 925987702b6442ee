"""Progressive render state: the per-pixel radiance sum, its sample
count and checkpoints (the counterpart of
tryraytrace_tpu/engine/state.py).  The sum stays on the render device;
the count is a host integer, so reading it never waits for the device.

Checkpoints are the JAX package's ``.npz`` archive with the same keys
and dtypes (``accum``, ``spp``, ``width``, ``height``, ``frame_seed``
and, with a camera, ``cam_*``), so a checkpoint written by either
package loads in the other.  The JAX package also writes Orbax
checkpoint directories (any path not ending in ``.npz``); Orbax is
JAX-only, so the port refuses such a path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tryraytrace_tpu_torch.camera.controller import CameraController


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


def _npz_path(path) -> str:
    path = str(path)
    if not path.endswith(".npz"):
        raise ValueError(
            f"checkpoint path {path!r} does not end in .npz: the port "
            "reads and writes .npz archives only (Orbax checkpoint "
            "directories are JAX-only)")
    return path


def save_checkpoint(path, state: RenderState, width: int, height: int,
                    camera=None, frame_seed: int = 0) -> None:
    """Persist accumulator + spp (+ optional camera pose) to ``path``, a
    ``.npz`` file (another suffix raises ``ValueError``)."""
    path = _npz_path(path)
    payload = dict(
        accum=state.accum.detach().cpu().numpy(),
        spp=np.asarray(state.spp, dtype=np.int32),
        width=np.int64(width),
        height=np.int64(height),
        frame_seed=np.int64(frame_seed),
    )
    if camera is not None:
        payload.update(
            cam_pos=np.asarray(camera.pos),
            cam_yaw=np.float64(camera.yaw),
            cam_pitch=np.float64(camera.pitch),
            cam_aperture=np.float64(camera.aperture),
            cam_focus=np.float64(camera.focus_dist),
        )
    np.savez(path, **payload)


def load_checkpoint(path, device="cuda"):
    """Returns (RenderState on ``device``, width, height, frame_seed,
    CameraController or None) from a ``.npz`` checkpoint of either
    package.  ``device`` is the card by default; without one this
    raises unless ``device="cpu"``."""
    dev = resolve_device(device)
    with np.load(_npz_path(path)) as f:
        z = {k: f[k] for k in f.files}
    state = RenderState(
        torch.as_tensor(z["accum"], dtype=torch.float32, device=dev),
        int(z["spp"]))
    camera = None
    if "cam_pos" in z:
        camera = CameraController(tuple(np.asarray(z["cam_pos"])))
        camera.yaw = float(z["cam_yaw"])
        camera.pitch = float(z["cam_pitch"])
        camera.aperture = float(z["cam_aperture"])
        camera.focus_dist = float(z["cam_focus"])
        camera._update_camera_vectors()
    return (state, int(z["width"]), int(z["height"]), int(z["frame_seed"]),
            camera)

"""FPS camera controller and per-frame camera parameters.

A jax-free copy of tryraytrace_tpu/camera/controller.py (reference
camera.cpp:20-163, scene.h:64-72): the same basis math, so both
packages pack bit-identical parameters.  ``CameraParams`` is a plain
dataclass of float32 NumPy arrays; ``CameraParams.to(device)`` gives
the torch copy the engine reads.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

FOV_SCALE = np.float32(0.5135)  # tan(FOV/2) ~ 54.4 deg vertical; camera.cpp:147


@dataclasses.dataclass
class CameraParams:
    pos: object          # [3] f32 (NumPy, or a tensor after .to())
    cx: object           # [3] f32 (includes FOV * aspect scale)
    cy: object           # [3] f32 (includes FOV scale)
    dir: object          # [3] f32 (normalized)
    lens_radius: object  # scalar f32 (aperture / 2)
    focus_dist: object   # scalar f32

    @staticmethod
    def make(pos, cx, cy, direction, lens_radius, focus_dist) -> "CameraParams":
        # copy=True: the controller mutates its pos array in place for
        # q/e elevation, and packed params must stay immutable.
        f32 = lambda v: np.array(v, dtype=np.float32, copy=True)
        return CameraParams(f32(pos), f32(cx), f32(cy), f32(direction),
                            f32(lens_radius), f32(focus_dist))

    def to(self, device) -> "CameraParams":
        """The same parameters as float32 tensors on ``device`` (a field
        already there is kept as it is)."""
        as_array = lambda v: (v if isinstance(v, torch.Tensor)
                              else np.asarray(v))
        return CameraParams(*(
            torch.as_tensor(as_array(getattr(self, f.name)),
                            dtype=torch.float32, device=device)
            for f in dataclasses.fields(self)))


def _radians(deg: float) -> float:
    return deg * (np.pi / 180.0)


class CameraController:
    """Keyboard/mouse FPS camera with thin-lens optics state."""

    def __init__(self, position=(50.0, 50.0, 295.6), look_at=(0.0, 0.0, -1.0)):
        # look_at is accepted for signature parity but unused, exactly
        # like the reference (camera.cpp:20-27): orientation comes from
        # yaw/pitch defaults (-90 / 0 -> looking down -Z).
        self.pos = np.asarray(position, dtype=np.float32)
        self.yaw = -90.0
        self.pitch = 0.0
        self.move_speed = 2.5           # camera.h:77
        self.mouse_sensitivity = 0.1    # camera.h:78
        self.aperture = 0.0             # diameter; camera.h:82
        self.focus_dist = 240.0         # camera.h:83
        self._update_camera_vectors()

    def _update_camera_vectors(self) -> None:
        """Euler -> orthonormal basis (camera.cpp:38-61)."""
        cy = np.cos(_radians(self.yaw))
        sy = np.sin(_radians(self.yaw))
        cp = np.cos(_radians(self.pitch))
        sp = np.sin(_radians(self.pitch))
        front = np.array([cy * cp, sp, sy * cp], dtype=np.float32)
        self.dir = front / np.linalg.norm(front)
        world_up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        right = np.cross(self.dir, world_up)
        self.right = (right / np.linalg.norm(right)).astype(np.float32)
        up = np.cross(self.right, self.dir)
        self.up = (up / np.linalg.norm(up)).astype(np.float32)

    def process_mouse(self, xrel: float, yrel: float) -> bool:
        """Yaw/pitch from mouse deltas, pitch clamped (camera.cpp:66-81)."""
        self.yaw += xrel * self.mouse_sensitivity
        self.pitch -= yrel * self.mouse_sensitivity
        self.pitch = float(np.clip(self.pitch, -89.0, 89.0))
        self._update_camera_vectors()
        return True

    def update(self, delta_time: float, keys: set[str]) -> bool:
        """Apply one tick of key state; returns True if the camera moved
        (the caller must reset accumulation).  WASD move, Q/E world-Y
        elevate, R/F focus +-1.0, T/G aperture +-0.1 (camera.cpp:95-131).
        """
        moved = False
        v = self.move_speed * delta_time
        if "w" in keys:
            self.pos = self.pos + self.dir * v
            moved = True
        if "s" in keys:
            self.pos = self.pos - self.dir * v
            moved = True
        if "a" in keys:
            self.pos = self.pos - self.right * v
            moved = True
        if "d" in keys:
            self.pos = self.pos + self.right * v
            moved = True
        if "q" in keys:
            self.pos[1] += v
            moved = True
        if "e" in keys:
            self.pos[1] -= v
            moved = True
        if "r" in keys:
            self.focus_dist += 1.0
            moved = True
            print(f"[Cam] Focus: {self.focus_dist:.1f}", file=sys.stderr)
        if "f" in keys:
            self.focus_dist = max(self.focus_dist - 1.0, 1.0)
            moved = True
            print(f"[Cam] Focus: {self.focus_dist:.1f}", file=sys.stderr)
        if "t" in keys:
            self.aperture += 0.1
            moved = True
            print(f"[Cam] Aperture: {self.aperture:.1f}", file=sys.stderr)
        if "g" in keys:
            self.aperture = max(self.aperture - 0.1, 0.0)
            moved = True
            print(f"[Cam] Aperture: {self.aperture:.1f}", file=sys.stderr)
        return moved

    def get_aperture(self) -> float:
        return self.aperture

    def get_focus_dist(self) -> float:
        return self.focus_dist

    def get_params(self, width: int, height: int) -> CameraParams:
        """Pack the per-frame parameters (camera.cpp:139-163)."""
        aspect = np.float32(width) / np.float32(height)
        cx = self.right * (FOV_SCALE * aspect)
        cy = self.up * FOV_SCALE
        return CameraParams.make(self.pos, cx, cy, self.dir,
                                 self.aperture * 0.5, self.focus_dist)

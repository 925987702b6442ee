"""Scene data model (a jax-free copy of tryraytrace_tpu/scene/model.py).

Parity targets: ``Object`` / ``Scene`` / ``CameraParams`` in the
reference (scene.h:30-85).  The reference stores an AoS array of
128-byte triangle+material records uploaded wholesale to the GPU
(renderer.cu:134-148); the TPU-native layout is SoA -- one contiguous
float32/int32 array per field -- which is what XLA tiles efficiently
and what the wavefront kernels gather from.

``flatten_scene`` is the analogue of ``init_scene_data``
(renderer.cu:134-184): it converts host objects to device-ready
arrays.  The light scan reproduces main.cpp:89-96 (emission > 0.1 on
any channel).
"""

from __future__ import annotations

import sys

import dataclasses
from typing import Sequence

import numpy as np

MAX_TEXTURES = 5  # parity with renderer.cu:20


@dataclasses.dataclass
class Object:
    """One triangle with a full PBR material (scene.h:30-55)."""

    v0: tuple[float, float, float]
    v1: tuple[float, float, float]
    v2: tuple[float, float, float]
    albedo: tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission: tuple[float, float, float] = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    roughness: float = 0.0
    ior: float = 0.0
    transmission: float = 0.0
    tex_id: int = -1
    # Optional per-corner vertex normals (smooth shading; the reference
    # has no normals at all).  (0,0,0) = none; the shader then uses the
    # geometric face normal.
    n0: tuple[float, float, float] = (0.0, 0.0, 0.0)
    n1: tuple[float, float, float] = (0.0, 0.0, 0.0)
    n2: tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Optional per-corner texture coordinates (OBJ ``vt``; the
    # reference loader drops slash-form faces so it never has UVs).
    # None = no UVs; texturing then uses the reference's planar
    # projection.  Inert unless RenderConfig.uv_mapping is on.
    uv0: tuple[float, float] | None = None
    uv1: tuple[float, float] | None = None
    uv2: tuple[float, float] | None = None


@dataclasses.dataclass
class Scene:
    """Host-side scene container (scene.h:80-85)."""

    objects: list[Object] = dataclasses.field(default_factory=list)
    texture_files: list[str] = dataclasses.field(default_factory=list)

    def world_bound(self) -> tuple[np.ndarray, np.ndarray]:
        """AABB over all vertices, padded by 0.1 (scene.cpp:106-117).

        Print-only in the reference (never consumed by the renderer);
        kept for API parity and logging.
        """
        vs = np.array(
            [[o.v0, o.v1, o.v2] for o in self.objects], dtype=np.float32
        ).reshape(-1, 3)
        return vs.min(axis=0) - 0.1, vs.max(axis=0) + 0.1


@dataclasses.dataclass
class SceneArrays:
    """Flattened SoA device arrays -- the engine's scene representation.

    All arrays are NumPy on creation; the engine moves them on-device
    (the ``jax.device_put`` analogue of the cudaMemcpy upload at
    renderer.cu:143-183).
    """

    tri_v0: np.ndarray      # [N, 3] f32
    tri_v1: np.ndarray      # [N, 3] f32
    tri_v2: np.ndarray      # [N, 3] f32
    albedo: np.ndarray      # [N, 3] f32
    emission: np.ndarray    # [N, 3] f32
    metallic: np.ndarray    # [N] f32
    roughness: np.ndarray   # [N] f32
    ior: np.ndarray         # [N] f32
    transmission: np.ndarray  # [N] f32
    tex_id: np.ndarray      # [N] i32 (-1 = untextured)
    light_indices: np.ndarray  # [L] i32
    textures: tuple = ()    # tuple of [H, W, 3] f32 arrays in [0, 1]
    # Per-corner vertex normals [N, 3] each; all-zero rows = no normal
    # (shader falls back to the geometric face normal).
    nrm0: np.ndarray | None = None
    nrm1: np.ndarray | None = None
    nrm2: np.ndarray | None = None
    # Per-corner UVs [N, 2] each + per-triangle flag [N] (1.0 = this
    # triangle carries real UVs; 0.0 = fall back to planar projection).
    uv0: np.ndarray | None = None
    uv1: np.ndarray | None = None
    uv2: np.ndarray | None = None
    uv_mask: np.ndarray | None = None

    @property
    def num_objects(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.light_indices.shape[0])

    def permuted(self, perm: np.ndarray) -> "SceneArrays":
        """Apply the BVH build's primitive reordering to every SoA
        array (the reference instead sorts the AoS vector in place,
        bvh.cpp:93; here the permutation is explicit and light indices
        are remapped through it).

        ``perm`` may be *surjective* rather than bijective: an SBVH
        build emits duplicated references to straddling triangles
        (accel/bvh.py _build_sbvh).  Duplicated slots carry identical
        data; each light maps to one canonical slot so the NEE pick
        pdf stays 1/(area*L)."""
        inv = np.empty(self.num_objects, dtype=np.int32)
        inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
        return SceneArrays(
            tri_v0=self.tri_v0[perm],
            tri_v1=self.tri_v1[perm],
            tri_v2=self.tri_v2[perm],
            albedo=self.albedo[perm],
            emission=self.emission[perm],
            metallic=self.metallic[perm],
            roughness=self.roughness[perm],
            ior=self.ior[perm],
            transmission=self.transmission[perm],
            tex_id=self.tex_id[perm],
            light_indices=inv[self.light_indices].astype(np.int32),
            textures=self.textures,
            nrm0=None if self.nrm0 is None else self.nrm0[perm],
            nrm1=None if self.nrm1 is None else self.nrm1[perm],
            nrm2=None if self.nrm2 is None else self.nrm2[perm],
            uv0=None if self.uv0 is None else self.uv0[perm],
            uv1=None if self.uv1 is None else self.uv1[perm],
            uv2=None if self.uv2 is None else self.uv2[perm],
            uv_mask=None if self.uv_mask is None else self.uv_mask[perm],
        )


def scan_lights(emission: np.ndarray, threshold: float = 0.1) -> np.ndarray:
    """Indices of emissive objects: any channel > threshold
    (main.cpp:89-96; note the deliberate mismatch with the kernel's
    1e-3 emitter-stop threshold, renderer.cu:497)."""
    mask = (emission > threshold).any(axis=-1)
    return np.nonzero(mask)[0].astype(np.int32)


def flatten_scene(
    scene: Scene,
    textures: Sequence[np.ndarray] | None = None,
    light_scan_threshold: float = 0.1,
) -> SceneArrays:
    """Scene -> SoA arrays + light scan (init_scene_data analogue).

    ``textures``: pre-loaded [H, W, 3] float32 images in [0, 1].  When
    None, texture files are loaded from disk with the PPM reader
    (load_texture_to_gpu analogue, renderer.cu:80-129); files that
    fail to load become 1x1 white textures (the reference returns a
    null texture handle and samples garbage; we choose the identity).
    """
    objs = scene.objects
    n = len(objs)

    def fvec(attr):
        return np.array([getattr(o, attr) for o in objs], dtype=np.float32).reshape(n, 3)

    def fscalar(attr, dtype=np.float32):
        return np.array([getattr(o, attr) for o in objs], dtype=dtype)

    emission = fvec("emission")
    if textures is None:
        textures = _load_textures(scene.texture_files)

    def fuv(attr):
        out = np.zeros((n, 2), np.float32)
        for i, o in enumerate(objs):
            val = getattr(o, attr)
            if val is not None:
                out[i] = val
        return out

    has_uv = np.array(
        [o.uv0 is not None and o.uv1 is not None and o.uv2 is not None
         for o in objs], dtype=np.float32)
    return SceneArrays(
        tri_v0=fvec("v0"),
        tri_v1=fvec("v1"),
        tri_v2=fvec("v2"),
        albedo=fvec("albedo"),
        emission=emission,
        metallic=fscalar("metallic"),
        roughness=fscalar("roughness"),
        ior=fscalar("ior"),
        transmission=fscalar("transmission"),
        tex_id=fscalar("tex_id", np.int32),
        light_indices=scan_lights(emission, light_scan_threshold),
        textures=tuple(textures),
        nrm0=fvec("n0"),
        nrm1=fvec("n1"),
        nrm2=fvec("n2"),
        uv0=fuv("uv0"),
        uv1=fuv("uv1"),
        uv2=fuv("uv2"),
        uv_mask=has_uv,
    )


def _load_textures(files: Sequence[str]) -> list[np.ndarray]:
    from tryraytrace_tpu_torch.io.ppm import load_ppm

    out = []
    for path in files[:MAX_TEXTURES]:
        try:
            img = load_ppm(path)
            out.append((img.astype(np.float32) / 255.0))
        except (OSError, ValueError) as e:
            print(f"[Texture Error] {e}; using 1x1 white stand-in", file=sys.stderr)
            out.append(np.ones((1, 1, 3), dtype=np.float32))
    return out

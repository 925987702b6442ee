"""Asset resolution and procedural stand-ins (a jax-free copy of
tryraytrace_tpu/scene/assets.py).

The reference ships `.obj` meshes under ``assets/`` (cube, teapot,
cow, teddy, pumpkin, temp) and one texture (``earth.ppm``).  No asset
data lives in this repo; paths resolve through the ``TPURT_ASSETS``
env var or an ``assets/`` directory at the repo root.  Procedural
generators below provide meshes/textures when no asset directory is
available and the checker-texture stand-in for ``earth.ppm``.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_ASSET_DIRS = (
    os.environ.get("TPURT_ASSETS", ""),
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets"),
)


def find_asset(name: str) -> str | None:
    """Resolve an asset filename to an existing path, or None."""
    if os.path.isabs(name) and os.path.exists(name):
        return name
    for d in DEFAULT_ASSET_DIRS:
        if not d:
            continue
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def cube_mesh(scale: float = 1.0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A unit cube [-1,1]^3 as 12 triangles: (v0, v1, v2) [12,3] f32."""
    c = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        dtype=np.float32,
    ) * np.float32(scale)
    # Each face: two CCW triangles (outward normals).
    quads = [
        (0, 1, 3, 2),  # x = -1
        (4, 6, 7, 5),  # x = +1
        (0, 4, 5, 1),  # y = -1
        (2, 3, 7, 6),  # y = +1
        (0, 2, 6, 4),  # z = -1
        (1, 5, 7, 3),  # z = +1
    ]
    tris = []
    for a, b, cc, d in quads:
        tris.append((a, b, cc))
        tris.append((a, cc, d))
    f = np.array(tris, dtype=np.int32)
    return c[f[:, 0]], c[f[:, 1]], c[f[:, 2]]


def icosphere_mesh(subdiv: int = 1, scale: float = 1.0):
    """Icosahedron subdivided `subdiv` times -> (v0, v1, v2) arrays."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdiv):
        vlist = list(verts)
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, dtype=np.int64)
    verts = (verts * scale).astype(np.float32)
    return verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]


def checker_texture(size: int = 256, cells: int = 8) -> np.ndarray:
    """Stand-in texture ([H,W,3] f32 in [0,1]) for the missing earth.ppm."""
    ix = np.arange(size) * cells // size
    cx, cy = np.meshgrid(ix, ix, indexing="xy")
    checks = ((cx + cy) % 2).astype(np.float32)
    img = np.empty((size, size, 3), dtype=np.float32)
    img[..., 0] = 0.2 + 0.7 * checks
    img[..., 1] = 0.35 + 0.45 * checks
    img[..., 2] = 0.8 - 0.5 * checks
    return img

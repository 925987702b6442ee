"""Cornell-box scene factory (a jax-free copy of
tryraytrace_tpu/scene/cornell.py).

Parity target: create_cornell_box (reference scene.cpp:24-123):
7 hardcoded wall/light triangles (one textured back wall, one mirror
front wall), plus teapot.obj at offset (50,10,50) scale 10 as a
metallic (m=1.0, r=0.1) mesh.  Texture slot 0 is ``earth.ppm``
(missing from the reference mount -- callers substitute the checker
stand-in via ``flatten_scene(textures=...)``).
"""

from __future__ import annotations

import sys

from tryraytrace_tpu_torch.scene.assets import find_asset
from tryraytrace_tpu_torch.scene.model import Object, Scene
from tryraytrace_tpu_torch.scene.objloader import load_obj

WHITE = (0.75, 0.75, 0.75)
RED = (0.75, 0.25, 0.25)
GREEN = (0.25, 0.75, 0.25)
LIGHT = (20.0, 20.0, 20.0)
BLACK = (0.0, 0.0, 0.0)

# Rough non-metal wall material (scene.cpp make_mat(0.0, 1.0)).
_WALL = dict(metallic=0.0, roughness=1.0, ior=1.45, transmission=0.0)


def create_cornell_box(mesh: str | None = "teapot.obj") -> Scene:
    scene = Scene()
    scene.texture_files.append("assets/earth.ppm")

    add = scene.objects.append
    # Floor (y=0)
    add(Object(v0=(-50, 0, 0), v1=(50, 0, 600), v2=(150, 0, 0),
               albedo=WHITE, emission=BLACK, tex_id=-1, **_WALL))
    # Ceiling (y=100)
    add(Object(v0=(-50, 100, 0), v1=(150, 100, 0), v2=(50, 100, 600),
               albedo=WHITE, emission=BLACK, tex_id=-1, **_WALL))
    # Back wall (z=0), textured with slot 0
    add(Object(v0=(-50, 0, 0), v1=(150, 0, 0), v2=(50, 200, 0),
               albedo=WHITE, emission=BLACK, tex_id=0, **_WALL))
    # Front wall (z=300), perfect mirror (scene.cpp:76-78)
    add(Object(v0=(-50, 0, 300), v1=(150, 0, 300), v2=(50, 200, 300),
               albedo=BLACK, emission=BLACK, metallic=1.0, roughness=0.0,
               ior=0.0, transmission=0.0, tex_id=-1))
    # Left wall (x=0), red
    add(Object(v0=(0, 0, -50), v1=(0, 200, 50), v2=(0, 0, 550),
               albedo=RED, emission=BLACK, tex_id=-1, **_WALL))
    # Right wall (x=100), green
    add(Object(v0=(100, 0, 550), v1=(100, 200, 50), v2=(100, 0, -50),
               albedo=GREEN, emission=BLACK, tex_id=-1, **_WALL))
    # Ceiling light (scene.cpp:87-89)
    add(Object(v0=(30, 99.9, 30), v1=(70, 99.9, 30), v2=(50, 99.9, 50),
               albedo=BLACK, emission=LIGHT, tex_id=-1, **_WALL))

    if mesh is not None:
        path = find_asset(mesh)
        if path is None:
            print(f"[Loader Error] Cannot open file: {mesh}", file=sys.stderr)
        else:
            # scene.cpp:96-101: offset (50,10,50), scale 10, white,
            # metallic=1.0, roughness=0.1.
            load_obj(path, scene.objects, offset=(50.0, 10.0, 50.0),
                     scale=10.0, albedo=WHITE, metallic=1.0, roughness=0.1)

    print(f"[Scene] Scene created with {len(scene.objects)} objects.", file=sys.stderr)
    lo, hi = scene.world_bound()
    print(
        "[Scene] World Bound: Min(%.1f, %.1f, %.1f) Max(%.1f, %.1f, %.1f)"
        % (lo[0], lo[1], lo[2], hi[0], hi[1], hi[2])
    , file=sys.stderr)
    return scene

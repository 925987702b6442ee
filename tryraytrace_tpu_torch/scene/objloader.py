"""Minimal Wavefront OBJ loader (a jax-free copy of
tryraytrace_tpu/scene/objloader.py).

Parity target: load_obj (reference loader.cpp:22-103).  Semantics
preserved exactly:

- only ``v x y z`` and ``f i j k`` lines are parsed;
- the model->world transform is baked at load time
  (``v*scale + offset``, loader.cpp:48-54);
- faces with slash syntax / quads / parse failures are silently
  skipped (loader.cpp:65-68);
- out-of-range (1-based) indices skip the face (loader.cpp:71-74);
- loaded triangles get ``tex_id = -1`` (loader.cpp:84-92) and no
  emission.

A native C++ parser (csrc/) accelerates large meshes; this module
falls back to pure Python when the extension is unavailable.
"""

from __future__ import annotations

import sys

import numpy as np

from tryraytrace_tpu_torch.scene.model import Object


def parse_obj_arrays(path) -> tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (vertices [V,3] f32, faces [F,3] i32, 0-based).

    Face rows are guaranteed in-range.
    """
    from tryraytrace_tpu_torch import native

    if native.available():
        parsed = native.parse_obj(path)
        if parsed is not None:
            return parsed
    return _parse_obj_python(path)


def _parse_obj_python(path) -> tuple[np.ndarray, np.ndarray]:
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                # The reference never checks the sscanf("v %f %f %f")
                # result (loader.cpp:49), so a malformed vertex line
                # still occupies an index slot.  Preserve the count:
                # unparseable components become 0.0 instead of the
                # reference's uninitialized garbage.
                parts = line.split()
                xyz = [0.0, 0.0, 0.0]
                for k in range(3):
                    if k + 1 < len(parts):
                        tok = parts[k + 1]
                        # float() accepts underscores that strtof does
                        # not; reject them for native/fallback parity.
                        if "_" in tok:
                            break
                        try:
                            xyz[k] = float(tok)
                        except ValueError:
                            break
                verts.append(tuple(xyz))
            elif line.startswith("f "):
                parts = line.split()
                # Exact sscanf("f %d %d %d") semantics (loader.cpp:63):
                # a non-digit suffix on a token (e.g. "1/1") makes the
                # *next* %d fail on the leftover '/', so the first two
                # index tokens must be pure integers while the third
                # only needs a leading integer; extra tokens ("f 1 2 3 4")
                # are ignored, so quads degrade to their first triangle.
                if len(parts) < 4:
                    continue
                i0 = _pure_int(parts[1])
                i1 = _pure_int(parts[2]) if i0 is not None else None
                lead = _leading_int(parts[3]) if i1 is not None else None
                if lead is None:
                    continue
                idx = (i0, i1, lead[0])
                if any(i < 1 or i > len(verts) for i in idx):
                    continue  # loader.cpp:71-74
                faces.append((idx[0] - 1, idx[1] - 1, idx[2] - 1))
    v = np.array(verts, dtype=np.float32).reshape(-1, 3)
    fc = np.array(faces, dtype=np.int32).reshape(-1, 3)
    return v, fc


_ASCII_DIGITS = "0123456789"


def _leading_int(tok: str):
    """Leading decimal integer with strtol semantics: optional sign,
    ASCII digits only (Python's int() would also accept underscores and
    unicode digits, which sscanf/strtol do not)."""
    i = 0
    if i < len(tok) and tok[i] in "+-":
        i += 1
    j = i
    while j < len(tok) and tok[j] in _ASCII_DIGITS:
        j += 1
    if j == i:
        return None
    return int(tok[:j]), j


def _pure_int(tok: str):
    """Fully-consumed decimal integer (the whole token is the number)."""
    got = _leading_int(tok)
    if got is None:
        return None
    value, end = got
    return value if end == len(tok) else None


def parse_obj_arrays_uv(path):
    """UV-aware OBJ parse -> (verts [V,3], faces [F,3], uvs [VT,2],
    uv_faces [F,3] with -1 rows where a face has no complete vt
    triple).  Beyond-reference mode: unlike the sscanf-exact default
    parser, slash-form faces (``f a/b c/d e/f``, ``a/b/c``, ``a//c``)
    are accepted here; quads still degrade to their first triangle.
    Out-of-range vertex indices skip the face; out-of-range vt indices
    only drop the face's UVs.
    """
    verts: list[tuple[float, float, float]] = []
    uvs: list[tuple[float, float]] = []
    faces: list[tuple[int, int, int]] = []
    uv_faces: list[tuple[int, int, int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                try:
                    verts.append((float(parts[1]), float(parts[2]),
                                  float(parts[3])))
                except (ValueError, IndexError):
                    verts.append((0.0, 0.0, 0.0))
            elif line.startswith("vt "):
                parts = line.split()
                try:
                    uvs.append((float(parts[1]), float(parts[2])))
                except (ValueError, IndexError):
                    uvs.append((0.0, 0.0))
            elif line.startswith("f "):
                parts = line.split()
                if len(parts) < 4:
                    continue
                vi: list[int] = []
                ti: list[int] = []
                for tok in parts[1:4]:
                    fields = tok.split("/")
                    got = _pure_int(fields[0])
                    vi.append(0 if got is None else got)
                    tgot = (_pure_int(fields[1])
                            if len(fields) > 1 and fields[1] else None)
                    ti.append(0 if tgot is None else tgot)
                if any(i < 1 or i > len(verts) for i in vi):
                    continue  # loader.cpp:71-74 semantics
                faces.append((vi[0] - 1, vi[1] - 1, vi[2] - 1))
                if all(1 <= i <= len(uvs) for i in ti):
                    uv_faces.append((ti[0] - 1, ti[1] - 1, ti[2] - 1))
                else:
                    uv_faces.append((-1, -1, -1))
    return (np.array(verts, np.float32).reshape(-1, 3),
            np.array(faces, np.int32).reshape(-1, 3),
            np.array(uvs, np.float32).reshape(-1, 2),
            np.array(uv_faces, np.int32).reshape(-1, 3))


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals [V, 3] from mesh connectivity.

    The reference loader drops normals entirely (loader.cpp parses only
    ``v``/``f`` lines -- and none of the reference assets carry ``vn``
    anyway), so smooth shading derives them: each face's unnormalized
    cross product (proportional to area) accumulates at its three
    corners, then each vertex sum is normalized.  Degenerate vertices
    (zero accumulated normal) stay zero; the shader falls back to the
    geometric face normal there.
    """
    nrm = np.zeros_like(verts)
    if faces.shape[0]:
        e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
        e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
        fn = np.cross(e1, e2)  # area-weighted
        for k in range(3):
            np.add.at(nrm, faces[:, k], fn)
    ln = np.sqrt((nrm * nrm).sum(-1, keepdims=True))
    return np.where(ln > 1e-20, nrm / np.where(ln > 0, ln, 1.0), 0.0).astype(
        np.float32)


def load_obj(
    path,
    objects: list[Object],
    offset=(0.0, 0.0, 0.0),
    scale: float = 1.0,
    albedo=(0.75, 0.75, 0.75),
    metallic: float = 0.0,
    roughness: float = 1.0,
    parse_uv: bool = False,
    tex_id: int = -1,
) -> int:
    """Append the mesh's triangles to ``objects``; returns count added.

    Missing files print an error and add nothing (loader.cpp:27-30).
    Vertex normals are computed from connectivity and attached to each
    triangle (inert unless RenderConfig.smooth_shading is on; the
    uniform positive scale + offset transform preserves directions).

    ``parse_uv=True`` (beyond-reference) switches to the UV-aware
    parser: slash-form faces are accepted (the reference skips them,
    loader.cpp:65-68) and complete ``vt`` triples are attached to
    each triangle; ``tex_id`` then selects the texture slot those UVs
    sample (default -1 = untextured, the reference's hardcoded choice,
    loader.cpp:84-92).
    """
    uvs = uv_faces = None
    try:
        if parse_uv:
            verts, faces, uvs, uv_faces = parse_obj_arrays_uv(path)
        else:
            verts, faces = parse_obj_arrays(path)
    except OSError:
        print(f"[Loader Error] Cannot open file: {path}", file=sys.stderr)
        return 0
    vnrm = compute_vertex_normals(verts, faces)
    verts = verts * np.float32(scale) + np.asarray(offset, dtype=np.float32)
    for fi, (a, b, c) in enumerate(faces):
        uv_kwargs = {}
        if uv_faces is not None and uv_faces[fi, 0] >= 0:
            ta, tb, tc = uv_faces[fi]
            uv_kwargs = dict(uv0=tuple(uvs[ta]), uv1=tuple(uvs[tb]),
                             uv2=tuple(uvs[tc]))
        objects.append(
            Object(
                v0=tuple(verts[a]),
                v1=tuple(verts[b]),
                v2=tuple(verts[c]),
                albedo=tuple(np.asarray(albedo, dtype=np.float32)),
                metallic=metallic,
                roughness=roughness,
                tex_id=tex_id,
                n0=tuple(vnrm[a]),
                n1=tuple(vnrm[b]),
                n2=tuple(vnrm[c]),
                **uv_kwargs,
            )
        )
    print(f"[Loader] Loaded: {path} ({verts.shape[0]} vertices, {faces.shape[0]} faces)", file=sys.stderr)
    return int(faces.shape[0])


"""ctypes bindings for the shared native C++ host runtime
(csrc/trt_native.cpp): the OBJ parser, the BVH builders and the host
tonemaps of the display pipeline.

A jax-free copy of tryraytrace_tpu/native.py restricted to what the
port's host layer calls.  It loads the same ``csrc/libtrt_native.so``
that ``csrc/Makefile`` builds (built on first use), so the JAX package
and the port build bit-identical BVHs.  Every entry point has a NumPy
fallback in its Python caller.

Build: ``make -C csrc`` (or let the first use build it).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
# csrc/Makefile's flags without -fopenmp, for toolchains that lack
# libgomp.  OpenMP only parallelises the library's tonemap loops; the
# BVH builders are serial code, so their output is unchanged.
_NO_OPENMP_FLAGS = "-O3 -march=native -ffp-contract=off -fPIC -Wall -std=c++17"


def _lib_path() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(here), "csrc", "libtrt_native.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get("TRT_NATIVE_LIB", _lib_path())
    if not os.path.exists(path):
        # Auto-build on first use (a ~5 s `make -C csrc`): a fresh
        # checkout must not silently run every BVH build on the NumPy
        # fallback (seconds per 10k triangles).  TRT_NATIVE_NO_BUILD=1
        # opts out (e.g. no toolchain).
        if (os.environ.get("TRT_NATIVE_NO_BUILD")
                or not os.path.exists(
                    os.path.join(os.path.dirname(path), "Makefile"))):
            return None
        for extra in ([], [f"CXXFLAGS={_NO_OPENMP_FLAGS}"]):
            try:
                subprocess.run(["make", "-C", os.path.dirname(path), *extra],
                               check=True, capture_output=True, timeout=120)
                break
            except (subprocess.SubprocessError, OSError):
                continue
        if not os.path.exists(path):
            return None
    try:
        lib = ctypes.CDLL(path)
        _configure(lib)
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def _configure(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.trt_parse_obj.restype = ctypes.c_int
    lib.trt_parse_obj.argtypes = [
        ctypes.c_char_p, f32p, i32p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.trt_tonemap.restype = None
    lib.trt_tonemap.argtypes = [f32p, u8p, ctypes.c_int64, ctypes.c_float]
    lib.trt_tonemap_argb.restype = None
    lib.trt_tonemap_argb.argtypes = [
        f32p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_float
    ]
    lib.trt_bvh_build.restype = ctypes.c_int64
    lib.trt_bvh_build.argtypes = [
        f32p, ctypes.c_int64,      # centroids [n,3], n
        f32p,                      # prim bounds [n,6]
        i32p,                      # out perm [n]
        f32p, i32p, i32p, i32p,    # out node bounds [2n,6], leaf_prim, miss, depth-ish
    ]
    if hasattr(lib, "trt_bvh_build_sah"):
        lib.trt_bvh_build_sah.restype = ctypes.c_int64
        lib.trt_bvh_build_sah.argtypes = [
            f32p, ctypes.c_int64,          # centroids [n,3], n
            f32p,                          # prim bounds [n,6]
            ctypes.c_int64, ctypes.c_int32,  # leaf_size, n_bins
            ctypes.c_double, ctypes.c_double,  # c_trav, c_isect
            i32p,                          # out perm [n]
            f32p, i32p, i32p, i32p,        # bounds, leaf_prim, leaf_count, miss
            i32p, i32p, i32p,              # left, right, axis
        ]


def available() -> bool:
    return _load() is not None


def parse_obj(path):
    """Native OBJ parse -> (verts [V,3] f32, faces [F,3] i32) or None."""
    lib = _load()
    if lib is None:
        return None
    size = os.path.getsize(path)
    # Upper bounds: a vertex/face line is >= 8 bytes ("v 0 0 0\n").
    cap = max(size // 7 + 16, 64)
    verts = np.empty((cap, 3), dtype=np.float32)
    faces = np.empty((cap, 3), dtype=np.int32)
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    rc = lib.trt_parse_obj(
        os.fsencode(path),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap, ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc != 0:
        return None
    return verts[: nv.value].copy(), faces[: nf.value].copy()


def tonemap(accum: np.ndarray, frame: int) -> np.ndarray | None:
    """Native average+gamma+quantize -> uint8 RGB, or None."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(accum, dtype=np.float32).reshape(-1)
    n = flat.shape[0] // 3
    out = np.empty(n * 3, dtype=np.uint8)
    lib.trt_tonemap(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, ctypes.c_float(1.0 / max(frame, 1)),
    )
    return out.reshape(accum.shape[:-1] + (3,)) if accum.ndim > 1 else out


def tonemap_argb(accum: np.ndarray, frame: int) -> np.ndarray | None:
    """Native tonemap to packed 0xAARRGGBB uint32 [n] (pipeline.cpp:59-71
    parity), or None."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(accum, dtype=np.float32).reshape(-1)
    n = flat.shape[0] // 3
    out = np.empty(n, dtype=np.uint32)
    lib.trt_tonemap_argb(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n, ctypes.c_float(1.0 / max(frame, 1)),
    )
    return out


def bvh_build_sah(centroids: np.ndarray, prim_bounds: np.ndarray,
                  leaf_size: int, n_bins: int = 16, c_trav: float = 1.0,
                  c_isect: float = 0.4):
    """Native binned-SAH fat-leaf build, bit-identical to the NumPy
    builder (accel/bvh.py _build_sah); returns
    (perm, bounds, leaf_prim, leaf_count, miss, left, right, axis,
    n_nodes) or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "trt_bvh_build_sah"):
        return None
    n = centroids.shape[0]
    cap = max(2 * n - 1, 1)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    perm = np.empty(n, dtype=np.int32)
    bounds = np.empty((cap, 6), dtype=np.float32)
    outs = [np.empty(cap, dtype=np.int32) for _ in range(6)]
    leaf_prim, leaf_count, miss, left, right, axis = outs
    n_nodes = lib.trt_bvh_build_sah(
        np.ascontiguousarray(centroids, np.float32).ctypes.data_as(f32p),
        n,
        np.ascontiguousarray(prim_bounds, np.float32).ctypes.data_as(f32p),
        leaf_size, n_bins,
        ctypes.c_double(c_trav), ctypes.c_double(c_isect),
        perm.ctypes.data_as(i32p),
        bounds.ctypes.data_as(f32p),
        *(a.ctypes.data_as(i32p) for a in outs),
    )
    if n_nodes <= 0:
        return None
    return (perm, bounds[:n_nodes], leaf_prim[:n_nodes],
            leaf_count[:n_nodes], miss[:n_nodes], left[:n_nodes],
            right[:n_nodes], axis[:n_nodes], int(n_nodes))


def bvh_build(centroids: np.ndarray, prim_bounds: np.ndarray):
    """Native BVH build; returns
    (perm, node_bounds, leaf_prim, miss, axis, n_nodes) or None."""
    lib = _load()
    if lib is None:
        return None
    n = centroids.shape[0]
    cap = max(2 * n - 1, 1)
    perm = np.empty(n, dtype=np.int32)
    node_bounds = np.empty((cap, 6), dtype=np.float32)
    leaf_prim = np.empty(cap, dtype=np.int32)
    miss = np.empty(cap, dtype=np.int32)
    axis = np.empty(cap, dtype=np.int32)
    n_nodes = lib.trt_bvh_build(
        np.ascontiguousarray(centroids, np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)),
        n,
        np.ascontiguousarray(prim_bounds, np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        node_bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        leaf_prim.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        axis.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n_nodes <= 0:
        return None
    return (perm, node_bounds[:n_nodes], leaf_prim[:n_nodes],
            miss[:n_nodes], axis[:n_nodes], int(n_nodes))

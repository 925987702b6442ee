"""Host-side BVH builder and table packers (jax-free copy of the parts
of tryraytrace_tpu/accel/bvh.py on the port's main path).

The builds (median split, binned SAH, SAH with spatial splits) emit
the same *threaded* linear BVH as the JAX package: preorder layout,
miss links, contiguous fat leaves, and an explicit primitive
permutation (surjective for the spatial-split build, whose straddling
triangles are referenced from both sides).  ``refit_bvh`` recomputes
the bounds of a tree over moved vertices.  The packers produce the
quad-row traversal table (``pack_quad_table`` over the collapsed 4-ary
tree, ``collapse_bvh``, with "bw" or "mt" leaf slots), the threaded
rows the bounce engine walks (``pack_traversal_table``, per-octant
links from ``thread_octant``) and the fused triangle+material rows
(``pack_trimat_table``) byte for byte as the JAX package does, so both
packages walk identical tables.  The pair/fat-node/octant tables are
not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

AABB_PAD = np.float32(1e-3)  # bvh.cpp:21-27


@dataclasses.dataclass
class LinearBVH:
    """Flat threaded BVH, preorder layout.

    With ``leaf_size=1`` (the reference's singleton-leaf shape,
    bvh.cpp:67-72) there are exactly ``2n - 1`` nodes.  Fat leaves
    (``leaf_size > 1``) hold up to that many *contiguous* primitives;
    they trade tree depth for per-visit work, which is the right
    trade on TPU where the per-visit row fetch is the cost unit and
    in-row vector math is effectively free.
    """

    bounds: np.ndarray      # [M, 6] f32: min xyz, max xyz
    leaf_prim: np.ndarray   # [M] i32: first primitive slot if leaf, else -1
    leaf_count: np.ndarray  # [M] i32: primitives in leaf (0 for internal)
    miss: np.ndarray        # [M] i32: preorder skip pointer; M = done
    left: np.ndarray        # [M] i32: left child (-1 for leaf)   [debug/tests]
    right: np.ndarray       # [M] i32: right child (-1 for leaf)  [debug/tests]
    axis: np.ndarray        # [M] i32: split axis (debug parity, bvh.h:26)
    perm: np.ndarray        # [N] i32: perm[slot] = original primitive index
    # Quad collapse mapping ({root: [child ids]}) set by upload_scene.
    quad_children: dict | None = None

    @property
    def num_nodes(self) -> int:
        return int(self.bounds.shape[0])

    def max_depth(self) -> int:
        """Tree depth (root = 1)."""
        if self.num_nodes == 0:
            return 0
        depth = np.zeros(self.num_nodes, dtype=np.int32)
        depth[0] = 1
        for i in range(self.num_nodes):
            if self.left[i] >= 0:
                depth[self.left[i]] = depth[i] + 1
                depth[self.right[i]] = depth[i] + 1
        return int(depth.max())


def primitive_bounds(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Padded per-triangle AABBs [N, 6] (get_object_bounds, bvh.cpp:11-29)."""
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    thin = (hi - lo) < AABB_PAD
    lo = np.where(thin, lo - AABB_PAD, lo)
    hi = np.where(thin, hi + AABB_PAD, hi)
    return np.concatenate([lo, hi], axis=-1)


def centroids(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Triangle centroids (get_centroid, bvh.cpp:5-8; note 0.333333f)."""
    return ((v0 + v1 + v2) * np.float32(0.333333)).astype(np.float32)


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              use_native: bool = True, leaf_size: int = 1,
              method: str = "median") -> LinearBVH:
    """Build a threaded BVH.

    method="median": the reference's algorithm exactly (longest axis,
    centroid sort, median split by count; bvh.cpp:47-113).
    method="sah": binned surface-area-heuristic build -- same node
    layout and traversal contract, typically 25-50% fewer node visits
    on mesh scenes.  Closest-hit results are identical either way.
    method="sbvh": SAH plus spatial splits (Stich et al. 2009 style):
    overlapping nodes may be split by a plane, with straddling
    triangles *referenced* from both sides under clipped bounds --
    ``perm`` then maps reference slots to primitives surjectively
    (duplicates allowed).  Results identical (duplicate references
    carry identical triangle data; closest-hit is order-independent).
    Any other method raises ValueError.
    ``use_native=False`` takes the NumPy builders, which give the same
    tree as the native library (tests/test_torch_host.py).
    """
    n = int(v0.shape[0])
    if n == 0:
        e = np.empty
        return LinearBVH(e((0, 6), np.float32), e(0, np.int32), e(0, np.int32),
                         e(0, np.int32), e(0, np.int32), e(0, np.int32),
                         e(0, np.int32), e(0, np.int32))
    pb = primitive_bounds(v0, v1, v2)
    cent = centroids(v0, v1, v2)

    if method == "sah":
        if use_native:
            from tryraytrace_tpu_torch import native

            if native.available():
                res = native.bvh_build_sah(cent, pb, leaf_size)
                if res is not None:
                    (perm, bounds, leaf_prim, leaf_count, miss, left,
                     right, axis, _) = res
                    return LinearBVH(bounds, leaf_prim, leaf_count,
                                     miss, left, right, axis, perm)
        return _build_sah(pb, cent, leaf_size)
    if method == "sbvh":
        return _build_sbvh(pb, v0, v1, v2, leaf_size)
    if method != "median":
        raise ValueError(f"unknown bvh_method {method!r} "
                         "(expected 'sah', 'median' or 'sbvh')")

    if use_native and leaf_size == 1:
        from tryraytrace_tpu_torch import native

        if native.available():
            res = native.bvh_build(cent, pb)
            if res is not None:
                perm, node_bounds, leaf_prim, miss, axis, m = res
                return _rebuild_links(node_bounds, leaf_prim, miss, axis,
                                      perm)

    return _build_python(pb, cent, leaf_size)


def _num_nodes(m: int, leaf_size: int, cache: dict) -> int:
    """Node count of a median-split-by-count subtree over m prims."""
    got = cache.get(m)
    if got is not None:
        return got
    if m <= leaf_size:
        result = 1
    else:
        half = m // 2
        result = 1 + _num_nodes(half, leaf_size, cache) + _num_nodes(
            m - half, leaf_size, cache)
    cache[m] = result
    return result


def _build_python(pb: np.ndarray, cent: np.ndarray,
                  leaf_size: int = 1) -> LinearBVH:
    n = pb.shape[0]
    count_cache: dict = {}
    m = _num_nodes(n, leaf_size, count_cache)
    bounds = np.empty((m, 6), dtype=np.float32)
    leaf_prim = np.full(m, -1, dtype=np.int32)
    leaf_count = np.zeros(m, dtype=np.int32)
    miss = np.full(m, m, dtype=np.int32)
    left = np.full(m, -1, dtype=np.int32)
    right = np.full(m, -1, dtype=np.int32)
    axis_arr = np.zeros(m, dtype=np.int32)
    order = np.arange(n, dtype=np.int64)

    # Iterative preorder build; the work stack carries (start, end,
    # miss_link).  Allocation order is preorder, and subtree node
    # counts are deterministic (median split by count), so the right
    # child's index is known before the left subtree is built --
    # that's what lets miss links resolve in one pass.
    stack = [(0, n, m)]
    next_node = 0
    while stack:
        start, end, miss_link = stack.pop()
        idx = next_node
        next_node += 1
        seg = order[start:end]
        bb = pb[seg]
        lo = bb[:, :3].min(axis=0)
        hi = bb[:, 3:].max(axis=0)
        bounds[idx, :3] = lo
        bounds[idx, 3:] = hi
        miss[idx] = miss_link
        if end - start <= leaf_size:
            leaf_prim[idx] = start  # post-permutation slot
            leaf_count[idx] = end - start
            continue
        # Split axis: longest extent, reference tie-break (bvh.cpp:76-79).
        size = hi - lo
        ax = 0
        if size[1] > size[0]:
            ax = 1
        if size[2] > size[1] and size[2] > size[0]:
            ax = 2
        axis_arr[idx] = ax
        # Sort this segment by centroid along ax (bvh.cpp:85-93).
        seg_sorted = seg[np.argsort(cent[seg, ax], kind="stable")]
        order[start:end] = seg_sorted
        mid = start + (end - start) // 2
        left_idx = idx + 1
        right_idx = idx + 1 + _num_nodes(mid - start, leaf_size, count_cache)
        left[idx] = left_idx
        right[idx] = right_idx
        # LIFO: push right first so left is processed (allocated) next.
        stack.append((mid, end, miss_link))
        stack.append((start, mid, right_idx))

    return LinearBVH(bounds, leaf_prim, leaf_count, miss, left, right,
                     axis_arr, order.astype(np.int32))


def _flatten_preorder(t_lo, t_hi, t_left, t_right, t_axis, t_start,
                      t_count, perm) -> LinearBVH:
    """Preorder flatten with miss links, shared by the SAH and SBVH
    builders (the native builder mirrors it in csrc/trt_native.cpp):
    assigns final node ids depth-first-left, threading each node's
    miss link to the next preorder node outside its subtree.
    ``t_count[tid] > 0`` marks a leaf holding ``t_count`` contiguous
    reference slots starting at ``t_start``."""
    mm = len(t_lo)
    bounds = np.empty((mm, 6), np.float32)
    leaf_prim = np.full(mm, -1, np.int32)
    leaf_count = np.zeros(mm, np.int32)
    miss = np.full(mm, mm, np.int32)
    left = np.full(mm, -1, np.int32)
    right = np.full(mm, -1, np.int32)
    axis_arr = np.zeros(mm, np.int32)
    next_node = 0
    stack = [(0, mm)]  # (temp id, miss link in FINAL ids)
    while stack:
        tid, miss_link = stack.pop()
        nid = next_node
        next_node += 1
        bounds[nid, :3] = t_lo[tid]
        bounds[nid, 3:] = t_hi[tid]
        miss[nid] = miss_link
        axis_arr[nid] = t_axis[tid]
        if t_count[tid] > 0:
            leaf_prim[nid] = t_start[tid]
            leaf_count[nid] = t_count[tid]
            continue
        # Left child is allocated next (preorder); its subtree size
        # tells us the right child's final id.
        lsize = _subtree_size(t_left[tid], t_left, t_right)
        l_id = nid + 1
        r_id = nid + 1 + lsize
        left[nid] = l_id
        right[nid] = r_id
        stack.append((t_right[tid], miss_link))
        stack.append((t_left[tid], r_id))

    return LinearBVH(bounds[:next_node], leaf_prim[:next_node],
                     leaf_count[:next_node], miss[:next_node],
                     left[:next_node], right[:next_node],
                     axis_arr[:next_node],
                     np.asarray(perm, dtype=np.int32))


def _build_sah(pb: np.ndarray, cent: np.ndarray, leaf_size: int,
               n_bins: int = 16, c_trav: float = 1.0,
               c_isect: float = 0.4) -> LinearBVH:
    """Binned SAH top-down build (Wald 2007 style).

    ``c_isect`` is deliberately low: in the fused-row traversal a leaf's
    inline Moller-Trumbore tests are free vector math riding the row
    fetch, so the real cost unit is the NODE VISIT, not the primitive
    test.  On the teapot scene c_isect 1.5 -> 0.4 cut mean visits per
    primary ray from 17 to 7.4 at identical images (measured sweep in
    docs/PERFORMANCE.md).

    Two passes: a recursive phase producing a temporary child-linked
    tree (subtree sizes are data-dependent, unlike the median split),
    then a preorder flatten that assigns the final node ids and miss
    links expected by the threaded traversal.
    """
    n = pb.shape[0]
    order = np.arange(n, dtype=np.int64)
    cmin = pb[:, :3]
    cmax = pb[:, 3:]

    # Temp tree storage.
    t_lo: list[np.ndarray] = []
    t_hi: list[np.ndarray] = []
    t_left: list[int] = []
    t_right: list[int] = []
    t_axis: list[int] = []
    t_start: list[int] = []
    t_count: list[int] = []

    def half_area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    def rec(start: int, end: int) -> int:
        idx = len(t_lo)
        seg = order[start:end]
        lo = cmin[seg].min(axis=0)
        hi = cmax[seg].max(axis=0)
        t_lo.append(lo)
        t_hi.append(hi)
        t_left.append(-1)
        t_right.append(-1)
        t_axis.append(0)
        t_start.append(start)
        t_count.append(end - start)
        m = end - start
        if m <= 1:
            return idx

        c = cent[seg]
        clo = c.min(axis=0)
        chi = c.max(axis=0)
        best = None  # (cost, axis, bin_split, assignment)
        for ax in range(3):
            extent = chi[ax] - clo[ax]
            if extent <= 0:
                continue
            bins = np.minimum(
                ((c[:, ax] - clo[ax]) / extent * n_bins).astype(np.int64),
                n_bins - 1)
            # Per-bin counts and bounds.
            counts = np.bincount(bins, minlength=n_bins)
            blo = np.full((n_bins, 3), np.inf, np.float32)
            bhi = np.full((n_bins, 3), -np.inf, np.float32)
            for b in range(n_bins):
                mask = bins == b
                if counts[b]:
                    blo[b] = cmin[seg[mask]].min(axis=0)
                    bhi[b] = cmax[seg[mask]].max(axis=0)
            # Sweep: prefix/suffix areas.
            for split in range(1, n_bins):
                nl = counts[:split].sum()
                nr = m - nl
                if nl == 0 or nr == 0:
                    continue
                llo = blo[:split].min(axis=0)
                lhi = bhi[:split].max(axis=0)
                rlo = blo[split:].min(axis=0)
                rhi = bhi[split:].max(axis=0)
                cost = (half_area(llo, lhi) * nl
                        + half_area(rlo, rhi) * nr)
                if best is None or cost < best[0]:
                    best = (cost, ax, split, bins)

        parent_area = half_area(lo, hi)
        leaf_cost = c_isect * m
        if best is not None and parent_area > 0:
            split_cost = c_trav + c_isect * best[0] / parent_area
        else:
            split_cost = np.inf
        if (m <= leaf_size and
                (best is None or split_cost >= leaf_cost)):
            return idx  # SAH says leaf (and it fits a fat-leaf row)
        if best is None:
            # All centroids identical: force an even split.
            mid = start + m // 2
        else:
            _, ax, split, bins = best
            t_axis[idx] = ax
            left_mask = bins < split
            left_seg = seg[left_mask]
            right_seg = seg[~left_mask]
            if len(left_seg) == 0 or len(right_seg) == 0:
                mid = start + m // 2
            else:
                order[start:start + len(left_seg)] = left_seg
                order[start + len(left_seg):end] = right_seg
                mid = start + len(left_seg)
        t_left[idx] = rec(start, mid)
        t_right[idx] = rec(mid, end)
        t_count[idx] = 0
        return idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        rec(0, n)
    finally:
        sys.setrecursionlimit(old_limit)

    return _flatten_preorder(t_lo, t_hi, t_left, t_right, t_axis,
                             t_start, t_count, order)


def _clip_tri_slab(v0, v1, v2, axis: int, lo_p, hi_p):
    """Bounds of each triangle clipped to the slab
    ``lo_p <= x[axis] <= hi_p`` -> (lo[R,3], hi[R,3]).

    The clipped polygon's vertices are exactly: original vertices
    inside the slab, plus triangle-edge intersections with the two
    slab planes -- bounds over that candidate set are the exact
    clipped-triangle bounds (no polygon bookkeeping needed).
    Empty intersections yield lo > hi.
    """
    pts = np.stack([v0, v1, v2], axis=1)          # [R, 3, 3]
    r = pts.shape[0]
    cands = [pts]
    masks = [(pts[:, :, axis] >= lo_p[:, None])
             & (pts[:, :, axis] <= hi_p[:, None])]
    edges = ((0, 1), (1, 2), (2, 0))
    for plane in (lo_p, hi_p):
        for a, b in edges:
            pa, pb = pts[:, a], pts[:, b]
            da = pa[:, axis] - plane
            db = pb[:, axis] - plane
            cross = (da * db) < 0.0  # strict: endpoints handled above
            denom = np.where(cross, pb[:, axis] - pa[:, axis], 1.0)
            t = np.clip((plane - pa[:, axis]) / denom, 0.0, 1.0)
            p = pa + (pb - pa) * t[:, None]
            cands.append(p[:, None, :])
            masks.append(cross[:, None])
    cand = np.concatenate(cands, axis=1)          # [R, 9, 3]
    mask = np.concatenate(masks, axis=1)[..., None]
    lo = np.where(mask, cand, np.inf).min(axis=1).astype(np.float32)
    hi = np.where(mask, cand, -np.inf).max(axis=1).astype(np.float32)
    return lo, hi


def _pad_thin(lo: np.ndarray, hi: np.ndarray):
    """Degenerate-extent padding, same rule as primitive_bounds."""
    thin = (hi - lo) < AABB_PAD
    return (np.where(thin, lo - AABB_PAD, lo),
            np.where(thin, hi + AABB_PAD, hi))


def _sweep(blo, bhi, n_left, n_right):
    """The binned SAH sweep over the split planes 1..n_bins-1, as
    arrays: per split the cost ``A(left) * n_left + A(right) * n_right``
    (float64, from float32 areas, as the scalar sweep rounds them) and
    the two sides' bounds.  Splits that leave a side empty are marked
    invalid.  Returns (split, cost, llo, lhi, rlo, rhi) of the first
    cheapest valid split (the scalar sweep's strict ``<``), or None."""
    llo = np.minimum.accumulate(blo, axis=0)[:-1]
    lhi = np.maximum.accumulate(bhi, axis=0)[:-1]
    rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1][1:]
    rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1][1:]
    valid = (n_left > 0) & (n_right > 0)
    if not valid.any():
        return None

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    cost = area(llo, lhi) * n_left + area(rlo, rhi) * n_right
    j = int(np.argmin(np.where(valid, cost, np.inf)))
    return j + 1, cost[j], llo[j], lhi[j], rlo[j], rhi[j]


def _build_sbvh(pb: np.ndarray, v0: np.ndarray, v1: np.ndarray,
                v2: np.ndarray, leaf_size: int, n_bins: int = 16,
                c_trav: float = 1.0, c_isect: float = 0.4,
                alpha: float = 1e-5, max_ref_factor: float = 2.0
                ) -> LinearBVH:
    """Spatial-split BVH (Stich et al., "Spatial Splits in Bounding
    Volume Hierarchies", HPG 2009) adapted to the fused-row threaded
    layout: object splits exactly as _build_sah, plus chopped-binning
    spatial split candidates whenever the object split's children
    overlap by more than ``alpha`` of the root area.  A straddling
    triangle is *referenced* on both sides with exact clipped bounds
    (_clip_tri_slab); total references are capped at
    ``max_ref_factor * n`` after which spatial splits stop.

    Same node/traversal contract as the other builders; ``perm`` maps
    leaf slots to primitive ids surjectively.

    The same tree as the JAX package's builder, byte for byte
    (tests/test_torch_features.py); its per-bin loops and split sweeps
    run here as array operations: the bins' bounds as unbuffered
    minimum / maximum, every (reference, bin) clip of an axis in one
    ``_clip_tri_slab`` call (its rows are independent), and each sweep
    in ``_sweep``.  Min and max are exact, and the costs are rounded
    as the scalar code rounds them.
    """
    n = pb.shape[0]
    max_refs = int(max_ref_factor * n)
    # Reference pool (grows on spatial splits): the first n_refs rows.
    cap = max(n, max_refs)
    ref_prim = np.zeros(cap, np.int64)
    ref_prim[:n] = np.arange(n)
    ref_lo = np.zeros((cap, 3), np.float32)
    ref_hi = np.zeros((cap, 3), np.float32)
    ref_lo[:n] = pb[:, :3]
    ref_hi[:n] = pb[:, 3:]
    n_refs = n

    t_lo: list[np.ndarray] = []
    t_hi: list[np.ndarray] = []
    t_left: list[int] = []
    t_right: list[int] = []
    t_axis: list[int] = []
    t_refs: list[list[int] | None] = []  # leaf reference lists

    def half_area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    root_lo = pb[:, :3].min(axis=0)
    root_hi = pb[:, 3:].max(axis=0)
    root_area = max(half_area(root_lo, root_hi), 1e-30)

    def rec(refs: np.ndarray) -> int:
        nonlocal n_refs
        idx = len(t_lo)
        rlo = ref_lo[refs]
        rhi = ref_hi[refs]
        lo = rlo.min(axis=0)
        hi = rhi.max(axis=0)
        t_lo.append(lo)
        t_hi.append(hi)
        t_left.append(-1)
        t_right.append(-1)
        t_axis.append(0)
        t_refs.append(None)
        m = len(refs)
        if m <= 1:
            t_refs[idx] = refs.tolist()
            return idx

        cent = (rlo + rhi) * 0.5
        clo = cent.min(axis=0)
        chi = cent.max(axis=0)

        # --- object split (binned SAH over reference bounds) ---
        best_obj = None  # (cost, axis, bins, split, llo, lhi, rlo, rhi)
        for ax in range(3):
            extent = chi[ax] - clo[ax]
            if extent <= 0:
                continue
            bins = np.minimum(
                ((cent[:, ax] - clo[ax]) / extent * n_bins).astype(np.int64),
                n_bins - 1)
            counts = np.bincount(bins, minlength=n_bins)
            blo = np.full((n_bins, 3), np.inf, np.float32)
            bhi = np.full((n_bins, 3), -np.inf, np.float32)
            np.minimum.at(blo, bins, rlo)
            np.maximum.at(bhi, bins, rhi)
            n_left = np.cumsum(counts)[:-1]
            best = _sweep(blo, bhi, n_left, m - n_left)
            if best is not None and (best_obj is None
                                     or best[1] < best_obj[0]):
                split, cost, llo, lhi, rlo2, rhi2 = best
                best_obj = (cost, ax, bins, split, llo, lhi, rlo2, rhi2)

        # --- spatial split (chopped binning), gated by child overlap ---
        best_sp = None  # (cost, axis, plane)
        try_spatial = n_refs < max_refs and best_obj is not None
        if try_spatial:
            _, _, _, _, ollo, olhi, orlo, orhi = best_obj
            o_lo = np.maximum(ollo, orlo)
            o_hi = np.minimum(olhi, orhi)
            if np.all(o_hi > o_lo):
                overlap = half_area(o_lo, o_hi)
            else:
                overlap = 0.0
            try_spatial = overlap / root_area > alpha
        if try_spatial:
            prims = ref_prim[refs]
            for ax in range(3):
                extent = hi[ax] - lo[ax]
                if extent <= 0:
                    continue
                width = extent / n_bins
                b0 = np.minimum(((rlo[:, ax] - lo[ax]) / width)
                                .astype(np.int64), n_bins - 1)
                b1 = np.minimum(((rhi[:, ax] - lo[ax]) / width)
                                .astype(np.int64), n_bins - 1)
                b0 = np.maximum(b0, 0)
                b1 = np.maximum(b1, b0)
                # Every (reference, bin) pair the reference spans.
                span = b1 - b0 + 1
                pair_ref = np.repeat(np.arange(m), span)
                first = np.cumsum(span) - span
                pair_bin = (b0[pair_ref] + np.arange(pair_ref.size)
                            - first[pair_ref])
                planes = np.array([lo[ax] + b * width for b in range(n_bins)],
                                  np.float32)
                p_lo = planes[pair_bin]
                p_hi = p_lo + width
                pp = prims[pair_ref]
                cl, ch = _clip_tri_slab(v0[pp], v1[pp], v2[pp], ax, p_lo,
                                        p_hi)
                # Clipped piece cannot exceed the reference bounds.
                cl = np.maximum(cl, rlo[pair_ref])
                ch = np.minimum(ch, rhi[pair_ref])
                ok = (cl <= ch).all(axis=-1)
                blo = np.full((n_bins, 3), np.inf, np.float32)
                bhi = np.full((n_bins, 3), -np.inf, np.float32)
                np.minimum.at(blo, pair_bin[ok], cl[ok])
                np.maximum.at(bhi, pair_bin[ok], ch[ok])
                entry = np.bincount(b0, minlength=n_bins)
                exit_ = np.bincount(b1, minlength=n_bins)
                n_left = np.cumsum(entry)[:-1]
                n_right = np.cumsum(exit_[::-1])[::-1][1:]
                best = _sweep(blo, bhi, n_left, n_right)
                if best is not None and (best_sp is None
                                         or best[1] < best_sp[0]):
                    split = best[0]
                    best_sp = (best[1], ax, lo[ax] + split * width)

        parent_area = half_area(lo, hi)
        leaf_cost = c_isect * m
        obj_cost = (c_trav + c_isect * best_obj[0] / parent_area
                    if best_obj is not None and parent_area > 0 else np.inf)
        sp_cost = (c_trav + c_isect * best_sp[0] / parent_area
                   if best_sp is not None and parent_area > 0 else np.inf)
        if m <= leaf_size and leaf_cost <= min(obj_cost, sp_cost):
            t_refs[idx] = refs.tolist()
            return idx

        left_refs = right_refs = None
        if sp_cost < obj_cost and best_sp is not None:
            _, ax, plane = best_sp
            rl, rr = [], []
            prims = ref_prim[refs]
            fully_l = rhi[:, ax] <= plane
            fully_r = rlo[:, ax] >= plane
            straddle = ~fully_l & ~fully_r
            rl = [int(r) for r in refs[fully_l]]
            rr = [int(r) for r in refs[fully_r]]
            sidx = np.nonzero(straddle)[0]
            if sidx.size and n_refs + sidx.size <= max_refs:
                sp_prims = prims[sidx]
                neg_inf = np.full(sidx.size, -np.inf, np.float32)
                pos_inf = np.full(sidx.size, np.inf, np.float32)
                pl = np.full(sidx.size, plane, np.float32)
                cl_lo, cl_hi = _clip_tri_slab(v0[sp_prims], v1[sp_prims],
                                              v2[sp_prims], ax,
                                              neg_inf, pl)
                cr_lo, cr_hi = _clip_tri_slab(v0[sp_prims], v1[sp_prims],
                                              v2[sp_prims], ax,
                                              pl, pos_inf)
                for j, si in enumerate(sidx):
                    old = refs[si]

                    def side(clip_lo, clip_hi, is_left):
                        # Conservative base: ref box cut at the plane
                        # (always non-empty for a straddling box);
                        # tighten by the clipped-triangle bounds when
                        # the clip is non-empty (a padded thin box can
                        # straddle while the triangle itself doesn't).
                        base_lo = rlo[si].copy()
                        base_hi = rhi[si].copy()
                        if is_left:
                            base_hi[ax] = plane
                        else:
                            base_lo[ax] = plane
                        s_lo = np.maximum(clip_lo, base_lo)
                        s_hi = np.minimum(clip_hi, base_hi)
                        if not np.all(s_lo <= s_hi):
                            s_lo, s_hi = base_lo, base_hi
                        return _pad_thin(s_lo.astype(np.float32),
                                         s_hi.astype(np.float32))

                    l_lo, l_hi = side(cl_lo[j], cl_hi[j], True)
                    r_lo, r_hi = side(cr_lo[j], cr_hi[j], False)
                    # Left side reuses the ref slot; right side is new.
                    ref_lo[old] = l_lo
                    ref_hi[old] = l_hi
                    rl.append(int(old))
                    ref_prim[n_refs] = ref_prim[old]
                    ref_lo[n_refs] = r_lo
                    ref_hi[n_refs] = r_hi
                    rr.append(n_refs)
                    n_refs += 1
            else:
                # Budget exhausted: send straddlers to the smaller side.
                for si in sidx:
                    c = (rlo[si, ax] + rhi[si, ax]) * 0.5
                    (rl if c < plane else rr).append(int(refs[si]))
            if len(rl) == 0 or len(rr) == 0:
                left_refs = right_refs = None
            else:
                t_axis[idx] = ax
                left_refs = np.array(rl, dtype=np.int64)
                right_refs = np.array(rr, dtype=np.int64)

        if left_refs is None:
            if best_obj is None:
                half = m // 2
                left_refs, right_refs = refs[:half], refs[half:]
            else:
                _, ax, bins, split, *_ = best_obj
                t_axis[idx] = ax
                lmask = bins < split
                left_refs, right_refs = refs[lmask], refs[~lmask]

        t_left[idx] = rec(left_refs)
        t_right[idx] = rec(right_refs)
        return idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        rec(np.arange(n, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old_limit)

    # Emit the final reference order (leaf refs contiguous), then the
    # same preorder flatten with miss links as the SAH build.
    order: list[int] = []
    t_start = [0] * len(t_lo)
    t_count = [0] * len(t_lo)
    for tid, refs in enumerate(t_refs):
        if refs is not None:
            t_start[tid] = len(order)
            t_count[tid] = len(refs)
            order.extend(int(ref_prim[i]) for i in refs)

    return _flatten_preorder(t_lo, t_hi, t_left, t_right, t_axis,
                             t_start, t_count, order)


def _subtree_size(tid: int, t_left, t_right) -> int:
    size = 0
    stack = [tid]
    while stack:
        t = stack.pop()
        size += 1
        if t_left[t] >= 0:
            stack.append(t_left[t])
            stack.append(t_right[t])
    return size


NUM_OCTANTS = 8


def leaf_slot_rows(v0, v1, v2, leaf_fmt: str = "bw"):
    """Per-triangle leaf slot payload: the Baldwin-Weber (n, v0, bu, bv)
    transform for "bw" (stride 12, ops/intersect.baldwin_rows) or
    (v0, e1, e2) for "mt" (stride 9; edges precomputed at pack time,
    bit-identical to in-step subtraction).  Both formats self-mask on
    all-zero pad slots."""
    from tryraytrace_tpu_torch.ops.intersect import baldwin_rows

    if leaf_fmt == "bw":
        return baldwin_rows(v0, v1, v2)
    if leaf_fmt != "mt":
        raise ValueError(f"unknown leaf_fmt {leaf_fmt!r}")
    return np.concatenate([v0, v1 - v0, v2 - v0], axis=-1)


# Floats per leaf slot of each format: the pack widths here and the
# decode offsets in ops/traverse.py both read it.
LEAF_STRIDE = {"bw": 12, "mt": 9}
# Each format's number in the walk kernels (their leaf-format template
# argument in csrc/quad_walk.cu and csrc/threaded_walk.cu).
LEAF_FORMATS = {fmt: i for i, fmt in enumerate(LEAF_STRIDE)}


def thread_octant(bvh: LinearBVH, octant: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-octant threading: (next_hit, next_miss) int32 [M].

    For ray-direction octant ``octant`` (bit k set = d_k < 0) the walk
    descends into the near child first: the left child lies on the low
    side of the node's split axis, so near = left iff the ray points
    positive on that axis.  Closest-hit results do not depend on the
    order (strict < on t) except between exact ties."""
    m = bvh.num_nodes
    next_hit = np.full(m, m, np.int32)
    next_miss = np.full(m, m, np.int32)
    if m == 0:
        return next_hit, next_miss
    leaf = (bvh.leaf_prim >= 0).tolist()
    axis, left, right = (a.tolist() for a in (bvh.axis, bvh.left, bvh.right))
    stack = [(0, m)]
    while stack:
        n, cont = stack.pop()
        next_miss[n] = cont
        if leaf[n]:
            next_hit[n] = cont
            continue
        if (octant >> axis[n]) & 1:
            near, far = right[n], left[n]
        else:
            near, far = left[n], right[n]
        next_hit[n] = near
        stack.append((far, cont))
        stack.append((near, far))
    return next_hit, next_miss


def traversal_row_width(leaf_size: int, leaf_fmt: str = "mt") -> int:
    """bounds (6) + K inline triangle slots + prim_start + prim_count +
    next_hit[8] + next_miss[8] = stride * K + 24 floats."""
    return LEAF_STRIDE[leaf_fmt] * leaf_size + 24


def pack_traversal_table(bvh: LinearBVH, v0: np.ndarray, v1: np.ndarray,
                         v2: np.ndarray, leaf_size: int | None = None,
                         leaf_fmt: str = "mt") -> np.ndarray:
    """Threaded traversal rows float32 [M, stride * K + 24], byte for byte
    the JAX package's: the node's box (cols 0:6), up to K inline leaf
    slots of format ``leaf_fmt`` (a leaf's primitives are contiguous, so
    slot j is primitive prim_start + j), prim_start (-1 internal) and
    prim_count, then the per-octant threaded continuations next_hit[8]
    and next_miss[8] (node ids, sentinel M = done)."""
    m = bvh.num_nodes
    k = int(leaf_size if leaf_size is not None
            else max(1, bvh.leaf_count.max() if m else 1))
    st = LEAF_STRIDE[leaf_fmt]
    w = traversal_row_width(k, leaf_fmt)
    if m == 0:
        return np.zeros((0, w), np.float32)
    if bvh.leaf_count.max() > k:
        raise ValueError(f"leaf_size {k} < max leaf count "
                         f"{bvh.leaf_count.max()}")
    table = np.zeros((m, w), np.float32)
    table[:, 0:6] = bvh.bounds
    tri_cat = leaf_slot_rows(v0, v1, v2, leaf_fmt)  # [T, stride]
    for j in range(k):
        nodes = np.nonzero(bvh.leaf_count > j)[0]
        table[nodes, 6 + st * j:6 + st * (j + 1)] = tri_cat[
            bvh.leaf_prim[nodes].astype(np.int64) + j]
    col = 6 + st * k
    table[:, col] = bvh.leaf_prim.astype(np.float32)
    table[:, col + 1] = bvh.leaf_count.astype(np.float32)
    for o in range(NUM_OCTANTS):
        nh, nm = thread_octant(bvh, o)
        table[:, col + 2 + o] = nh.astype(np.float32)
        table[:, col + 10 + o] = nm.astype(np.float32)
    return table


# Node ids are stored as float32, which holds every integer below 2^24.
MAX_FLOAT_ID = 2 ** 24


def threaded_walk_order_table(table, leaf_size: int, leaf_fmt: str = "bw"):
    """The walk's copy of a threaded table (pack_traversal_table): the
    same rows in breadth-first order, root first and each internal row's
    children in id order (left, then right), padded at the right end to
    a multiple of 4 floats (16-byte rows: 72 stays 72 at leaf size 4
    with "bw" slots, 78 -> 80 at leaf size 6 with "mt" slots).  Every
    node id in the 16 link columns is renamed with its row; ids at or
    past the row count (the walk's done sentinel) are kept.  The columns
    stay where they are.

    The walks reach the same rows in the same order on either table:
    the renaming fixes row 0, and the walk tests ids only against the
    sentinel; its outputs carry ``prim_start``, not row ids.  So the
    plain walks (ops/traverse.py) read the copy unchanged.  An internal
    row's children are its octant-0 ``next_hit`` (the left child) and
    the other id among its eight.

    Raises when an id reaches 2^24 (float32 would not hold it exactly)
    or the links do not make a binary tree under row 0.

    Returns (table [rows, width] float32 NumPy, rows per tree level)."""
    src = np.asarray(table, np.float32)
    n, w = src.shape
    if w != traversal_row_width(leaf_size, leaf_fmt):
        raise ValueError(f"threaded rows of {w} floats, leaf size "
                         f"{leaf_size} with {leaf_fmt!r} slots needs "
                         f"{traversal_row_width(leaf_size, leaf_fmt)}")
    if n >= MAX_FLOAT_ID:
        raise ValueError(f"{n} rows: node ids must stay below 2^24")
    width = -(-w // 4) * 4
    if n == 0:
        return np.zeros((0, width), np.float32), []
    col = 6 + LEAF_STRIDE[leaf_fmt] * leaf_size
    links = slice(col + 2, col + 2 + 2 * NUM_OCTANTS)
    ids = src[:, links].astype(np.int64)
    if ids.min() < 0 or ids.max() >= MAX_FLOAT_ID:
        raise ValueError("node ids must lie in [0, 2^24)")
    internal = src[:, col] < 0
    near = ids[:, :NUM_OCTANTS]
    left = near[:, 0]
    right = np.where(near != left[:, None], near, -1).max(axis=1)
    if (internal & (right < 0)).any():
        raise ValueError("an internal row has one child: not a binary tree")
    order, levels = [], []
    level = np.zeros(1, np.int64)
    while level.size:
        order.append(level)
        levels.append(int(level.size))
        inner = level[internal[level]]
        level = np.stack([left[inner], right[inner]], 1).reshape(-1)
        if level.size and level.max() >= n:
            raise ValueError("a child id is past the rows: not a tree")
        if sum(levels) + level.size > n:
            raise ValueError("the links revisit rows: not a tree under "
                             "row 0")
    order = np.concatenate(order)
    if order.size != n or np.unique(order).size != n:
        raise ValueError("the threaded rows are not a tree under row 0")
    new_id = np.empty(n + 1, np.int64)
    new_id[order] = np.arange(n)
    new_id[n] = n

    out = np.zeros((n, width), np.float32)
    out[:, :w] = src[order]
    moved = ids[order]
    out[:, links] = np.where(moved < n, new_id[np.minimum(moved, n)],
                             moved)
    return out, levels


QUAD_WIDTH = 4
QUAD_COL_CONT = 2
QUAD_COL_BODY = 10
QB_BOX = 0        # body-relative offsets
QB_ENT = 24
QB_NSLOTS = 28
QUAD_BODY_INT = 29


def quad_row_width(leaf_size: int, leaf_fmt: str = "bw") -> int:
    return QUAD_COL_BODY + max(QUAD_BODY_INT,
                               LEAF_STRIDE[leaf_fmt] * leaf_size)


def collapse_bvh(bvh: LinearBVH, width: int = QUAD_WIDTH,
                 criterion: str = "count") -> dict:
    """Collapse the binary BVH into a ``width``-ary tree.

    Returns {binary root id: [child binary ids]} for every collapsed
    node; children are original binary node ids (internal children
    become collapsed roots themselves, leaf children stay leaves).

    ``criterion`` picks which internal child each greedy expansion
    step splits into the row's remaining slots:

    * ``"count"`` -- subtree primitive count (the heavy subtree is
      the one worth splitting finer).  Topology-only: re-collapsing
      after a bounds refit reproduces the identical mapping.
    * ``"sa"`` -- child surface area.  A ray that fetched X's row
      enters child c with probability ~SA(c)/SA(X) (the SAH measure),
      and expanding c saves exactly that expected row fetch, so
      greedy-by-SA maximizes expected fetches removed per slot spent.
    * ``"dp"`` -- exact minimizer of the same objective sa
      approximates: E[internal row fetches] = sum over collapsed
      roots r of SA(r) under the SAH visit measure (leaf rows are
      fetched whenever entered regardless of the grouping, so they
      drop out of the objective).  Bottom-up DP over the binary tree:
      cost(x) = SA(x) + min over binary cuts of x's subtree with
      <= ``width`` frontier members of the internal members' costs
      (a handful of cut shapes at width 4).

    "sa"/"dp" depend on bounds, so re-collapsing after a refit could
    change the mapping; refit stability comes from upload_scene
    stashing the build-time mapping on LinearBVH.quad_children and the
    refit path repacking with it (same table shape, new bounds).
    """
    is_leaf = bvh.leaf_prim >= 0
    m = bvh.num_nodes
    if criterion == "dp":
        d = np.maximum(bvh.bounds[:, 3:] - bvh.bounds[:, :3], 0.0)
        sa = (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
              + d[:, 2] * d[:, 0]).astype(np.float64)
        cost = np.zeros(m, np.float64)
        best_cut: dict[int, list[int]] = {}

        def cuts(x):
            """All binary cuts of x's children frontier, width-capped."""
            out = []
            seen = set()
            stack = [(int(bvh.left[x]), int(bvh.right[x]))]
            while stack:
                cut = stack.pop()
                if cut in seen:
                    continue
                seen.add(cut)
                out.append(list(cut))
                if len(cut) >= width:
                    continue
                for i, c in enumerate(cut):
                    if not is_leaf[c]:
                        nxt = (cut[:i]
                               + (int(bvh.left[c]), int(bvh.right[c]))
                               + cut[i + 1:])
                        stack.append(tuple(nxt))
            return out

        for x in range(m - 1, -1, -1):
            if is_leaf[x]:
                continue
            best = None
            for cut in cuts(x):
                c_cost = sum(cost[c] for c in cut if not is_leaf[c])
                if best is None or c_cost < best[0]:
                    best = (c_cost, cut)
            cost[x] = sa[x] + best[0]
            best_cut[x] = best[1]
        children: dict[int, list[int]] = {}
        todo = [0]
        while todo:
            x = todo.pop()
            if is_leaf[x] or x in children:
                continue
            children[x] = best_cut[x]
            todo.extend(c for c in best_cut[x] if not is_leaf[c])
        return children
    if criterion == "count":
        # Subtree primitive counts, children-before-parents (the linear
        # layout stores children after their parent, so a reverse sweep
        # has both child counts ready).
        key = np.where(is_leaf, bvh.leaf_count, 0).astype(np.int64)
        for x in range(m - 1, -1, -1):
            if not is_leaf[x]:
                key[x] = key[bvh.left[x]] + key[bvh.right[x]]
    elif criterion == "sa":
        d = np.maximum(bvh.bounds[:, 3:] - bvh.bounds[:, :3], 0.0)
        key = (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
               + d[:, 2] * d[:, 0]).astype(np.float64)
    else:
        raise ValueError(f"unknown collapse criterion {criterion!r}")
    children: dict[int, list[int]] = {}
    todo = [0]
    while todo:
        x = todo.pop()
        if is_leaf[x] or x in children:
            continue
        out = [int(bvh.left[x]), int(bvh.right[x])]
        while len(out) < width:
            cands = [i for i, c in enumerate(out) if not is_leaf[c]]
            if not cands:
                break
            i = max(cands, key=lambda i: (key[out[i]], -out[i]))
            c = out.pop(i)
            out[i:i] = [int(bvh.left[c]), int(bvh.right[c])]
        children[x] = out
        todo.extend(c for c in out if not is_leaf[c])
    return children


def pack_quad_table(bvh: LinearBVH, v0: np.ndarray, v1: np.ndarray,
                    v2: np.ndarray, leaf_size: int,
                    children: dict, leaf_fmt: str = "bw") -> np.ndarray:
    """Quad-row table (layout above) over the collapsed tree
    ``children`` (collapse_bvh), with ``leaf_fmt`` leaf slots.  The packed
    permutation byte holds, per front-to-back POSITION, the child SLOT
    at that position in 2 bits (the JAX package's default "pos2slot";
    its "slot2pos" rank layout is not ported)."""
    m = bvh.num_nodes
    k = int(leaf_size)
    st = LEAF_STRIDE[leaf_fmt]
    w = quad_row_width(k, leaf_fmt)
    if m == 0:
        return np.zeros((0, w), np.float32)
    if bvh.leaf_count.max() > k:
        raise ValueError(
            f"leaf_size {k} < max leaf count {bvh.leaf_count.max()}")
    is_leaf = bvh.leaf_prim >= 0
    # Compact row ids: collapsed roots + binary leaves, in binary-id
    # order (the binary root is node 0, so its row is 0).  Absorbed
    # binary internals have no row.
    used = sorted(set(children.keys())
                  | set(np.nonzero(is_leaf)[0].tolist()))
    rowid = {b: r for r, b in enumerate(used)}
    nrows = len(used)
    if nrows > 32767:
        raise ValueError(
            f"quad table has {nrows} rows; the packed cont*256+perm "
            "column is exact in float32 only up to 32767 rows")
    assert used[0] == 0 or is_leaf[0]
    table = np.zeros((nrows, w), np.float32)
    table[:, 0] = bvh.leaf_prim[used].astype(np.float32)
    table[:, 1] = bvh.leaf_count[used].astype(np.float32)

    # Canonical slots + boxes + entries (octant-independent).
    b0 = QUAD_COL_BODY
    for x, kids in children.items():
        r = rowid[x]
        ns = len(kids)
        for i in range(QUAD_WIDTH):
            if i < ns:
                table[r, b0 + QB_BOX + 6 * i:b0 + QB_BOX + 6 * i + 6] = (
                    bvh.bounds[kids[i]])
                table[r, b0 + QB_ENT + i] = rowid[kids[i]]
            else:
                table[r, b0 + QB_BOX + 6 * i:b0 + QB_BOX + 6 * i + 3] = 1e30
                table[r, b0 + QB_BOX + 6 * i + 3:
                      b0 + QB_BOX + 6 * i + 6] = -1e30
                table[r, b0 + QB_ENT + i] = nrows
        table[r, b0 + QB_NSLOTS] = ns

    # Per-octant ordering (approximate front-to-back: centroid dot the
    # octant direction) -> the position permutation, and the threaded
    # continuations over the collapsed tree.
    cent = 0.5 * (bvh.bounds[:, :3] + bvh.bounds[:, 3:])
    for ob in range(NUM_OCTANTS):
        sign = np.array([1 - 2 * ((ob >> a) & 1) for a in range(3)],
                        np.float32)
        stack = [(0, nrows)]
        while stack:
            x, cont = stack.pop()
            if x not in children:
                table[rowid[x], QUAD_COL_CONT + ob] = cont * 256
                continue
            kids = children[x]
            key = (cent[kids] * sign).sum(-1)
            order = np.argsort(key, kind="stable")
            perm = 0
            for pos in range(QUAD_WIDTH):
                slot = int(order[pos]) if pos < len(order) else 3
                perm |= slot << (2 * pos)
            table[rowid[x], QUAD_COL_CONT + ob] = cont * 256 + perm
            for pos, oi in enumerate(order):
                c = kids[oi]
                nxt = (rowid[kids[order[pos + 1]]]
                       if pos + 1 < len(order) else cont)
                stack.append((int(c), int(nxt)))

    tri_cat = leaf_slot_rows(v0, v1, v2, leaf_fmt)
    for x in np.nonzero(bvh.leaf_count > 0)[0]:
        start = int(bvh.leaf_prim[x])
        cnt = int(bvh.leaf_count[x])
        table[rowid[x], QUAD_COL_BODY:QUAD_COL_BODY + st * cnt] = (
            tri_cat[start:start + cnt].reshape(-1))
    return table


def walk_order_table(quad_table, leaf_size: int, leaf_fmt: str = "bw"):
    """The walk's copy of a quad table (pack_quad_table): the same rows
    in breadth-first order, root first and each row's children in slot
    order, padded to a multiple of 4 floats (16-byte rows: 58 -> 60 at
    leaf size 4 with "bw" slots, 46 -> 48 with "mt" slots).  Every row id inside a row is renamed with its row:
    the entry columns of internal rows and the continuation of each
    octant (``cont * 256 + perm``: ``cont`` renamed, ``perm`` kept).
    Ids at or past the row count (the walk's done sentinel) are kept.

    The walk reaches the same rows in the same order on either table:
    the renaming fixes row 0 and the sentinel, and the walk only tests
    ids for equality (the skip registers), for 0 and against the
    sentinel.  The CUDA walk stages the top levels of this copy in
    shared memory.

    Returns (table [rows, width] float32 NumPy, rows per tree level)."""
    src = np.asarray(quad_table, np.float32)
    n, w = src.shape
    if w != quad_row_width(leaf_size, leaf_fmt):
        raise ValueError(f"quad rows of {w} floats, leaf size {leaf_size} "
                         f"with {leaf_fmt!r} slots needs "
                         f"{quad_row_width(leaf_size, leaf_fmt)}")
    width = -(-w // 4) * 4
    if n == 0:
        return np.zeros((0, width), np.float32), []
    ent = slice(QUAD_COL_BODY + QB_ENT, QUAD_COL_BODY + QB_ENT + QUAD_WIDTH)
    internal = src[:, 0] < 0
    order, levels = [], []
    level = np.zeros(1, np.int64)
    while level.size:
        order.append(level)
        levels.append(int(level.size))
        inner = level[internal[level]]
        nslots = src[inner, QUAD_COL_BODY + QB_NSLOTS].astype(np.int64)
        used = np.arange(QUAD_WIDTH)[None, :] < nslots[:, None]
        level = src[inner, ent].astype(np.int64)[used]
    order = np.concatenate(order)
    if order.size != n or np.unique(order).size != n:
        raise ValueError("the quad rows are not a tree under row 0")
    new_id = np.empty(n + 1, np.int64)
    new_id[order] = np.arange(n)
    new_id[n] = n

    def rename(ids):
        return np.where(ids < n, new_id[np.minimum(ids, n)], ids)

    out = np.zeros((n, width), np.float32)
    out[:, :w] = src[order]
    inner = out[:, 0] < 0
    out[inner, ent] = rename(out[inner, ent].astype(np.int64))
    conts = slice(QUAD_COL_CONT, QUAD_COL_CONT + NUM_OCTANTS)
    packed = out[:, conts].astype(np.int64)
    out[:, conts] = rename(packed >> 8) * 256 + (packed & 255)
    return out, levels


# Packed hit-data row layout (float32[37]): everything shading needs
# about the hit primitive in one gather (rows are free to >= 112
# floats on v5e, docs/PERFORMANCE.md).
TRIMAT_WIDTH = 37
TM_TRI = slice(0, 9)          # v0 v1 v2
TM_ALBEDO = slice(9, 12)
TM_EMISSION = slice(12, 15)
TM_METALLIC = 15
TM_ROUGHNESS = 16
TM_IOR = 17
TM_TRANSMISSION = 18
TM_TEX_ID = 19
TM_AREA = 20                  # precomputed triangle area (NEE pdf)
TM_NRM = slice(21, 30)        # per-corner vertex normals (n0 n1 n2;
                              # all-zero = none -> geometric normal)
TM_UV = slice(30, 36)         # per-corner UVs (uv0 uv1 uv2)
TM_UV_FLAG = 36               # 1.0 = UVs valid (else planar mapping)


def pack_trimat_table(arrays) -> np.ndarray:
    """Fused triangle+material rows float32[T, 30] (BVH prim order)."""
    t = arrays.tri_v0.shape[0]
    out = np.zeros((t, TRIMAT_WIDTH), np.float32)
    out[:, TM_TRI] = np.concatenate(
        [arrays.tri_v0, arrays.tri_v1, arrays.tri_v2], axis=-1)
    out[:, TM_ALBEDO] = arrays.albedo
    out[:, TM_EMISSION] = arrays.emission
    out[:, TM_METALLIC] = arrays.metallic
    out[:, TM_ROUGHNESS] = arrays.roughness
    out[:, TM_IOR] = arrays.ior
    out[:, TM_TRANSMISSION] = arrays.transmission
    out[:, TM_TEX_ID] = arrays.tex_id.astype(np.float32)
    e1 = arrays.tri_v1 - arrays.tri_v0
    e2 = arrays.tri_v2 - arrays.tri_v0
    cr = np.cross(e1, e2)
    out[:, TM_AREA] = 0.5 * np.sqrt((cr * cr).sum(-1))
    if getattr(arrays, "nrm0", None) is not None:
        out[:, TM_NRM] = np.concatenate(
            [arrays.nrm0, arrays.nrm1, arrays.nrm2], axis=-1)
    if getattr(arrays, "uv0", None) is not None:
        out[:, TM_UV] = np.concatenate(
            [arrays.uv0, arrays.uv1, arrays.uv2], axis=-1)
        out[:, TM_UV_FLAG] = arrays.uv_mask
    return out


def refit_bvh(bvh: LinearBVH, v0: np.ndarray, v1: np.ndarray,
              v2: np.ndarray) -> LinearBVH:
    """Recompute node bounds for deformed geometry, reusing the tree.

    Beyond-reference: the reference builds its BVH once at startup and
    never rebuilds (bvh.cpp:32-45; SURVEY.md L3 "no refit, no
    rebuild"), so animated geometry is impossible there.  A refit is
    O(N) vs the O(N log^2 N) rebuild and keeps the topology (miss
    links, leaf spans, permutation) identical -- only ``bounds`` and
    the packed tables change, and every table keeps its shape.

    ``v0/v1/v2`` are the *slot-ordered* triangle vertices (i.e. after
    ``arrays.permuted(bvh.perm)``), deformed but with unchanged
    topology.  Leaf bounds use the same degenerate-axis padding as the
    build (primitive_bounds); internal bounds are child unions,
    computed level-by-level bottom-up (vectorized per depth).  Note an
    SBVH's spatially *clipped* leaf boxes are refit to full triangle
    boxes -- still conservative/correct, just looser than a fresh
    spatial-split build.
    """
    m = bvh.num_nodes
    if m == 0:
        return bvh
    pb = primitive_bounds(v0, v1, v2)
    bounds = np.array(bvh.bounds, dtype=np.float32, copy=True)

    # Leaves: union over each leaf's contiguous primitive span.
    leaves = np.nonzero(bvh.leaf_count > 0)[0]
    if leaves.size:
        start = bvh.leaf_prim[leaves].astype(np.int64)
        count = bvh.leaf_count[leaves].astype(np.int64)
        lo = pb[start, :3].copy()
        hi = pb[start, 3:].copy()
        for k in range(1, int(count.max())):
            has = count > k
            idx = start + np.minimum(k, count - 1)
            lo = np.where(has[:, None], np.minimum(lo, pb[idx, :3]), lo)
            hi = np.where(has[:, None], np.maximum(hi, pb[idx, 3:]), hi)
        bounds[leaves, :3] = lo
        bounds[leaves, 3:] = hi

    # Internal nodes, deepest level first (preorder guarantees children
    # have larger ids, but per-level grouping vectorizes the sweep).
    depth = np.zeros(m, dtype=np.int32)
    internal = bvh.left >= 0
    for i in range(m):
        if internal[i]:
            depth[bvh.left[i]] = depth[i] + 1
            depth[bvh.right[i]] = depth[i] + 1
    for lvl in range(int(depth.max()), -1, -1):
        idx = np.nonzero(internal & (depth == lvl))[0]
        if not idx.size:
            continue
        l, r = bvh.left[idx], bvh.right[idx]
        bounds[idx, :3] = np.minimum(bounds[l, :3], bounds[r, :3])
        bounds[idx, 3:] = np.maximum(bounds[l, 3:], bounds[r, 3:])

    return dataclasses.replace(bvh, bounds=bounds)


def _rebuild_links(bounds, leaf_prim, miss, axis, perm) -> LinearBVH:
    """Derive left/right from a (bounds, leaf_prim, miss, axis) tuple
    produced by the native builder (preorder layout, singleton leaves)."""
    m = bounds.shape[0]
    left = np.full(m, -1, dtype=np.int32)
    right = np.full(m, -1, dtype=np.int32)
    internal = leaf_prim < 0
    idx = np.nonzero(internal)[0]
    left[idx] = idx + 1
    # right child = miss link of the left child's subtree root.
    right[idx] = miss[idx + 1]
    leaf_count = (~internal).astype(np.int32)
    return LinearBVH(bounds.astype(np.float32), leaf_prim.astype(np.int32),
                     leaf_count, miss.astype(np.int32), left, right,
                     axis.astype(np.int32), perm.astype(np.int32))

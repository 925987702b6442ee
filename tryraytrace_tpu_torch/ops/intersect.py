"""Ray/triangle intersection for the two leaf formats.

The counterpart of tryraytrace_tpu/ops/intersect.py.  "bw" leaves:
``baldwin_rows`` packs the per-triangle Baldwin-Weber transform on the
host (NumPy, byte-identical to the JAX package), ``baldwin_intersect``
evaluates it on torch tensors.  "mt" leaves: ``moller_trumbore_pre``
tests the packed (v0, e1, e2) slots.  Both keep the decision structure
of the reference's Moller-Trumbore (renderer.cu:235-268): the 1e-5
parallel guard, barycentric bounds u >= 0, v >= 0, u + v <= 1, and the
hit window t > 1e-5; both self-mask on all-zero pad slots.
"""

from __future__ import annotations

import numpy as np
import torch

from tryraytrace_tpu_torch.core import vec

EPS = 1e-5


def baldwin_rows(v0, v1, v2) -> np.ndarray:
    """Pack-time Baldwin-Weber rows [T, 12]: (n, v0, bu, bv), with
    n = e1 x e2 unnormalized and the barycentric gradient rows divided
    out in float64.  Degenerate triangles pack as all-zero rows, which
    the parallel guard rejects (the same self-masking as pad slots)."""
    e1 = (v1 - v0).astype(np.float64)
    e2 = (v2 - v0).astype(np.float64)
    n = np.cross(e1, e2)
    nn = (n * n).sum(-1, keepdims=True)
    safe = np.where(nn > 0, nn, 1.0)
    rows = np.concatenate([n, v0.astype(np.float64),
                           np.cross(e2, n) / safe,
                           np.cross(n, e1) / safe], axis=-1)
    return np.where(nn > 0, rows, 0.0).astype(np.float32)


def baldwin_intersect(rows, r_o, r_d) -> torch.Tensor:
    """rows [..., 12] from ``baldwin_rows``; r_o / r_d [..., 3]
    (broadcast against rows' leading axes).  Returns t [...] with 0 for
    a miss.  Evaluated v0-relative (s = o - v0 first), like the JAX
    kernel."""
    n_ = rows[..., 0:3]
    v0 = rows[..., 3:6]
    bu = rows[..., 6:9]
    bv = rows[..., 9:12]
    nd = vec.dot(n_, r_d)
    parallel = torch.abs(nd) < EPS
    f = 1.0 / torch.where(parallel, 1.0, nd)
    s = r_o - v0
    t = -f * vec.dot(n_, s)
    p = s + t[..., None] * r_d
    u = vec.dot(bu, p)
    v = vec.dot(bv, p)
    valid = (~parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > EPS))
    return torch.where(valid, t, 0.0)


def moller_trumbore_pre(v0, e1, e2, r_o, r_d) -> torch.Tensor:
    """Moller-Trumbore with precomputed edges e1 = v1 - v0, e2 = v2 - v0
    (the "mt" leaf slot), all [..., 3] and broadcast against each
    other.  Returns t [...] with 0 for a miss; a zero (v0, e1, e2) slot
    is parallel, hence a miss.  The operation order is the JAX
    kernel's, and ``f`` is an IEEE division."""
    h = vec.cross(r_d, e2)
    a = vec.dot(e1, h)
    parallel = torch.abs(a) < EPS
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = r_o - v0
    u = f * vec.dot(s, h)
    q = vec.cross(s, e1)
    v = f * vec.dot(r_d, q)
    t = f * vec.dot(e2, q)
    valid = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > EPS))
    return torch.where(valid, t, 0.0)

"""Texture addressing for the inline-texturing path.

The counterpart of tryraytrace_tpu/ops/texture.py.  Textures are cut
into TEX_TILE x TEX_TILE base tiles, each stored as one row of
(TEX_TILE+1)^2 texels (a one-texel wrap apron right and below), so any
bilinear footprint is served by one row of the persistent engine's
unified table.  ``build_texture_tiles`` builds those rows on the host
(NumPy, byte-identical to the JAX package); ``tile_coords`` and
``tile_bilinear`` address and filter them on torch tensors with the
tap arithmetic of the reference's CUDA sampler (texel centres at
(i+0.5)/W, wrap addressing, bilinear filter; renderer.cu:80-129).
The bounce engine samples the raw textures with the same arithmetic
(``sample_bilinear_wrap``, ``sample_textures``), a 4-tap gather.
"""

from __future__ import annotations

import numpy as np
import torch

TEX_TILE = 4
TEX_APRON = TEX_TILE + 1
TEX_ROW = TEX_APRON * TEX_APRON * 3  # 75 f32 per tile row


def sample_bilinear_wrap(tex, u, v):
    """Sample ``tex`` [H, W, 3] at normalized (u, v) [N] -> [N, 3], as the
    reference's CUDA linear filter does: texel centres at (i+0.5)/W,
    sample point x = frac(u)*W - 0.5, wrap addressing of the taps."""
    h, w = int(tex.shape[0]), int(tex.shape[1])
    x = (u - torch.floor(u)) * w - 0.5
    y = (v - torch.floor(v)) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64) % w
    y0i = y0.to(torch.int64) % h
    x1i = (x0i + 1) % w
    y1i = (y0i + 1) % h
    flat = tex.reshape(h * w, tex.shape[2])
    c00 = flat[y0i * w + x0i]
    c10 = flat[y0i * w + x1i]
    c01 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_textures(textures, tex_id, u, v):
    """Multiplicative texture factor [N, 3] at (u, v): texture slot k
    where ``tex_id == k``, 1 elsewhere (no texture, or a slot past the
    last).  ``textures`` is a sequence of [H, W, 3] float32 tensors on
    the lanes' device; each is sampled for the whole wave and selected
    by mask, as the JAX sampler does."""
    factor = torch.ones(u.shape + (3,), dtype=torch.float32,
                        device=u.device)
    for k, tex in enumerate(textures):
        texel = sample_bilinear_wrap(tex, u, v)
        factor = torch.where((tex_id == k)[..., None], texel, factor)
    return factor


def planar_uv(x_hit, n, scale: float):
    """Planar-projection UVs (renderer.cu:465-476): the plane follows the
    dominant |normal| axis (y first, then x, else z), coordinates scale
    by ``scale`` and V flips."""
    nx = torch.abs(n[..., 0])
    ny = torch.abs(n[..., 1])
    y_dom = ny > 0.9
    x_dom = (~y_dom) & (nx > 0.9)
    u = torch.where(y_dom, x_hit[..., 0],
                    torch.where(x_dom, x_hit[..., 2], x_hit[..., 0]))
    v = torch.where(y_dom, x_hit[..., 2],
                    torch.where(x_dom, x_hit[..., 1], x_hit[..., 1]))
    u = u * scale
    v = 1.0 - v * scale
    return u, v


def interp_uv(uv_row, b1, b2):
    """Barycentric-interpolated (u, v) from a per-corner UV row [..., 6]
    = (u0 v0 u1 v1 u2 v2), V flipped once after interpolation."""
    b0 = 1.0 - b1 - b2
    u = uv_row[..., 0] * b0 + uv_row[..., 2] * b1 + uv_row[..., 4] * b2
    v = uv_row[..., 1] * b0 + uv_row[..., 3] * b1 + uv_row[..., 5] * b2
    return u, 1.0 - v


def build_texture_tiles(textures):
    """Pack ``textures`` (sequence of [H, W, 3] float32 NumPy arrays)
    into tile rows.  Returns (rows [R, TEX_ROW] NumPy, metas, R) with
    metas[k] = {offset, tiles_x, w, h}: tile (ty, tx) of texture k is
    row ``offset + ty*tiles_x + tx``."""
    rows, metas, off = [], [], 0
    for tex in textures:
        tex = np.asarray(tex, np.float32)
        h, w = int(tex.shape[0]), int(tex.shape[1])
        tx = -(-w // TEX_TILE)
        ty = -(-h // TEX_TILE)
        gy = (np.arange(ty, dtype=np.int64)[:, None] * TEX_TILE
              + np.arange(TEX_APRON, dtype=np.int64)[None, :]) % h
        gx = (np.arange(tx, dtype=np.int64)[:, None] * TEX_TILE
              + np.arange(TEX_APRON, dtype=np.int64)[None, :]) % w
        idx = gy[:, None, :, None] * w + gx[None, :, None, :]
        flat = tex.reshape(h * w, 3)
        rows.append(flat[idx.reshape(-1)].reshape(ty * tx, TEX_ROW))
        metas.append(dict(offset=off, tiles_x=tx, w=w, h=h))
        off += ty * tx
    return np.concatenate(rows, axis=0), metas, off


def tile_coords(metas, tex_id, u, v):
    """Per-lane (tile_row, offx, offy, fx, fy) into the rows of
    ``build_texture_tiles``.  Lanes whose tex_id matches no texture get
    row 0 and zero weights (callers must not select them)."""
    zi = torch.zeros_like(tex_id)
    zf = torch.zeros_like(u)
    trow, offx, offy, fx, fy = zi, zi, zi, zf, zf
    for k, m in enumerate(metas):
        h, w = m["h"], m["w"]
        x = (u - torch.floor(u)) * w - 0.5
        y = (v - torch.floor(v)) * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        x0i = x0.to(tex_id.dtype) % w
        y0i = y0.to(tex_id.dtype) % h
        tx = x0i // TEX_TILE
        ty = y0i // TEX_TILE
        sel = tex_id == k
        trow = torch.where(sel, m["offset"] + ty * m["tiles_x"] + tx, trow)
        offx = torch.where(sel, x0i - tx * TEX_TILE, offx)
        offy = torch.where(sel, y0i - ty * TEX_TILE, offy)
        fx = torch.where(sel, x - x0, fx)
        fy = torch.where(sel, y - y0, fy)
    return trow, offx, offy, fx, fy


def tile_bilinear(row, offx, offy, fx, fy):
    """Bilinear sample from gathered tile rows [N, >= TEX_ROW] at in-tile
    offsets offx, offy in [0, TEX_TILE) and weights fx, fy.  The taps are
    read by index (the JAX kernel selects them by a one-hot sum, which
    is exact), then lerped top/bottom in the JAX association."""
    base = (offy * TEX_APRON + offx) * 3
    ch = torch.arange(3, device=row.device, dtype=base.dtype)

    def tap(dy, dx):
        return row.gather(1, (base + (dy * TEX_APRON + dx) * 3)[:, None] + ch)

    c00, c10 = tap(0, 0), tap(0, 1)
    c01, c11 = tap(1, 0), tap(1, 1)
    fx3 = fx[..., None]
    fy3 = fy[..., None]
    top = c00 * (1.0 - fx3) + c10 * fx3
    bot = c01 * (1.0 - fx3) + c11 * fx3
    return top * (1.0 - fy3) + bot * fy3

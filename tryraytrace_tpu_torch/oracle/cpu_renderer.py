"""Pure-NumPy CPU oracle renderer (a jax-free copy of
tryraytrace_tpu/oracle/cpu_renderer.py).

A deliberately *independent* implementation of the same algorithms --
brute-force closest-hit over every triangle (no BVH), straight-line
NumPy, no torch -- used to hold the port's render against the
reference: both share only the counter-based RNG spec (copied below
in NumPy), which is what makes frames bit-comparable.  Any traversal
bug, masking bug or kernel fault shows up as MSE against this renderer
(benchmarks.py ``run_config``, the tests).  Every branch of the JAX
oracle is kept: Moller-Trumbore or Baldwin-Weber intersection (the
engines' leaf format), smooth shading and UV mapping.

All formulas/constants mirror the reference megakernel
(renderer.cu:317-760); citations inline where behavior is quirky.
"""

from __future__ import annotations

import numpy as np

from tryraytrace_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from tryraytrace_tpu_torch.ops.intersect import EPS, baldwin_rows

PI = np.float32(np.pi)
F32 = np.float32


# -- the counter-based RNG in NumPy (tryraytrace_tpu/core/py:59-111) --
# Draw slots: the camera takes draws 0..3, bounce b the eight from
# CAMERA_DRAWS + b * DRAWS_PER_BOUNCE (core/py of the port).
CAMERA_DRAWS = 4
DRAWS_PER_BOUNCE = 8
SLOT_RR = 0
SLOT_BRANCH = 1
SLOT_DIR_R1 = 2
SLOT_DIR_R2 = 3
SLOT_LIGHT_PICK = 4
SLOT_LIGHT_R1 = 5
SLOT_LIGHT_R2 = 6

_INV_2_24 = np.float32(1.0 / 16777216.0)


def pcg(x):
    """PCG output permutation hash on uint32 values (vectorized)."""
    x = x.astype(np.uint32) if hasattr(x, "astype") else np.uint32(x)
    state = x * np.uint32(747796405) + np.uint32(2891336453)
    word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) \
        * np.uint32(277803737)
    return (word >> np.uint32(22)) ^ word


def _as_u32(v):
    if hasattr(v, "astype"):
        return v.astype(np.uint32)
    return np.uint32(np.uint32(v & 0xFFFFFFFF) if isinstance(v, int) else v)


def hash3(a, b, c):
    """Mix three uint32 streams into one hash value."""
    return pcg(_as_u32(a) + pcg(_as_u32(b) + pcg(_as_u32(c))))


def uniform(seed, stream, draw_id):
    """U(seed, stream, draw_id) -> float32 uniform in [0, 1), from the
    top 24 bits of the hash (exact in the float32 mantissa)."""
    # uint32 wraparound is the point of the hash.
    with np.errstate(over="ignore"):
        bits = hash3(seed, stream, draw_id)
        return (bits >> np.uint32(8)).astype(np.float32) * _INV_2_24


def baldwin_intersect(rows, r_o, r_d):
    """Baldwin-Weber intersection in NumPy (the ``xp=np`` branch of
    tryraytrace_tpu/ops/intersect.py:78): rows [..., 12] from
    ``baldwin_rows``; returns t [...] (0 = miss)."""
    n_ = rows[..., 0:3]
    v0 = rows[..., 3:6]
    bu = rows[..., 6:9]
    bv = rows[..., 9:12]
    nd = _dot(n_, r_d)
    parallel = np.abs(nd) < EPS
    f = 1.0 / np.where(parallel, np.float32(1.0), nd)
    s = r_o - v0
    t = -f * _dot(n_, s)
    p = s + t[..., None] * r_d
    u = _dot(bu, p)
    v = _dot(bv, p)
    valid = ((~parallel) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > EPS))
    return np.where(valid, t, np.float32(0.0))


def _barycentric(v0, v1, v2, x_hit):
    """Barycentric (b1, b2, ok) of ``x_hit`` in NumPy (the ``xp=np``
    branch of tryraytrace_tpu/ops/shade.py barycentric)."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = x_hit - v0
    d11 = _dot(e1, e1)
    d12 = _dot(e1, e2)
    d22 = _dot(e2, e2)
    dp1 = _dot(p, e1)
    dp2 = _dot(p, e2)
    den = d11 * d22 - d12 * d12
    ok_den = den > 1e-6 * d11 * d22
    inv = 1.0 / np.where(ok_den, den, 1.0)
    b1 = (d22 * dp1 - d12 * dp2) * inv
    b2 = (d11 * dp2 - d12 * dp1) * inv
    return b1, b2, ok_den


def _smooth_normal(v0, v1, v2, n0, n1, n2, x_hit, nrm_geo):
    """Interpolated vertex normal in NumPy (the ``xp=np`` branch of
    tryraytrace_tpu/ops/shade.py smooth_normal)."""
    b1, b2, ok_den = _barycentric(v0, v1, v2, x_hit)
    b0 = 1.0 - b1 - b2
    ns = n0 * b0[..., None] + n1 * b1[..., None] + n2 * b2[..., None]
    ns = np.where(_dot(ns, nrm_geo)[..., None] < 0.0, -ns, ns)
    len2 = _dot(ns, ns)
    ok = ok_den & (len2 > 1e-12)
    ns = ns / np.sqrt(np.where(ok, len2, 1.0))[..., None]
    return np.where(ok[..., None], ns, nrm_geo)


def _dot(a, b):
    return (a * b).sum(axis=-1)


def _norm(a):
    length = np.sqrt((a * a).sum(axis=-1, keepdims=True))
    return np.where(length > 0, a / np.where(length > 0, length, 1), a).astype(np.float32)


def _cross(a, b):
    return np.cross(a, b).astype(np.float32)


def _intersect_brute(v0, v1, v2, o, d, bw=None):
    """Closest hit of rays [N,3] against all triangles [T,3]: returns
    (t [N], id [N]).  Moller-Trumbore with the reference's epsilons;
    with ``bw`` (precomputed baldwin_rows, mirroring the engines'
    cfg.leaf_isect == "bw" tables) the same Baldwin-Weber kernel the
    engines run, for bit-comparability."""
    if bw is not None:
        t = baldwin_intersect(bw[None], o[:, None], d[:, None])
        t = np.where(t > 0, t, F32(np.inf))
        idx = t.argmin(axis=1)
        tmin = t[np.arange(t.shape[0]), idx]
        hit = np.isfinite(tmin)
        return (np.where(hit, tmin, F32(1e20)).astype(np.float32),
                np.where(hit, idx, -1).astype(np.int32))
    eps = F32(1e-5)
    e1 = (v1 - v0)[None]            # [1,T,3]
    e2 = (v2 - v0)[None]
    dN = d[:, None]                 # [N,1,3]
    oN = o[:, None]
    h = _cross(dN, e2)
    a = _dot(e1, h)
    parallel = np.abs(a) < eps
    f = 1.0 / np.where(parallel, 1.0, a)
    s = oN - v0[None]
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(dN, q)
    t = f * _dot(e2, q)
    valid = (~parallel) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > eps)
    t = np.where(valid, t, F32(np.inf))
    idx = t.argmin(axis=1)
    tmin = t[np.arange(t.shape[0]), idx]
    hit = np.isfinite(tmin)
    return (np.where(hit, tmin, F32(1e20)).astype(np.float32),
            np.where(hit, idx, -1).astype(np.int32))


def _occluded_brute(v0, v1, v2, o, d, max_dist, active, bw=None):
    """Any-hit: True where something blocks in (0.001, max_dist-0.001)
    (trace_shadow semantics, renderer.cu:273-314)."""
    if bw is not None:
        t = baldwin_intersect(bw[None], o[:, None], d[:, None])
        blocking = (t > 1e-3) & (t < (max_dist - 1e-3)[:, None])
        return blocking.any(axis=1) & active
    eps = F32(1e-5)
    e1 = (v1 - v0)[None]
    e2 = (v2 - v0)[None]
    dN = d[:, None]
    oN = o[:, None]
    h = _cross(dN, e2)
    a = _dot(e1, h)
    parallel = np.abs(a) < eps
    f = 1.0 / np.where(parallel, 1.0, a)
    s = oN - v0[None]
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(dN, q)
    t = f * _dot(e2, q)
    valid = (~parallel) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > eps)
    blocking = valid & (t > 1e-3) & (t < (max_dist - 1e-3)[:, None])
    return blocking.any(axis=1) & active


def _sample_sphere(u1, u2):
    r1 = u1 * F32(2 * np.pi)
    z = 1.0 - 2.0 * u2
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(r1), r * np.sin(r1), z], axis=-1).astype(np.float32)


def oracle_render(arrays, cam, width: int, height: int, frame_seed: int,
                  spp: int = 1, cfg: RenderConfig = DEFAULT_CONFIG,
                  textures=None) -> np.ndarray:
    """Render [H*W, 3] float32 radiance summed over ``spp`` samples.

    ``arrays``: SceneArrays (any primitive order -- brute force does
    not care about the BVH permutation).  ``cam``: CameraParams.
    """
    n = width * height
    out = np.zeros((n, 3), dtype=np.float32)
    textures = arrays.textures if textures is None else textures
    for s in range(spp):
        seed = np.uint32((1984 + frame_seed * spp + s) & 0xFFFFFFFF)
        out += _oracle_sample(arrays, cam, width, height, seed, cfg, textures)
    return out


def _oracle_sample(ar, cam, width, height, seed, cfg, textures):
    n = width * height
    pix = np.arange(n, dtype=np.uint32)
    U = lambda draw: uniform(seed, pix, np.uint32(draw))

    pos = np.asarray(cam.pos, np.float32)
    cx = np.asarray(cam.cx, np.float32)
    cy = np.asarray(cam.cy, np.float32)
    cdir = np.asarray(cam.dir, np.float32)
    lens_radius = F32(cam.lens_radius)
    focus = F32(cam.focus_dist)

    # --- ray generation (renderer.cu:331-356) ---
    x = (pix % width).astype(np.float32)
    y = (height - 1 - pix // width).astype(np.float32)
    r1 = 2.0 * U(0)
    r2 = 2.0 * U(1)
    dx = np.where(r1 < 1, np.sqrt(r1) - 1, 1 - np.sqrt(np.maximum(2 - r1, 0)))
    dy = np.where(r2 < 1, np.sqrt(r2) - 1, 1 - np.sqrt(np.maximum(2 - r2, 0)))
    sx = ((x + 0.5 + dx) / width - 0.5)[:, None]
    sy = ((y + 0.5 + dy) / height - 0.5)[:, None]
    dir_pinhole = _norm(cx * sx + cy * sy + cdir)
    lr = lens_radius * np.sqrt(U(2))
    lth = F32(2 * np.pi) * U(3)
    u_ax = _norm(cx[None])[0]
    v_ax = _norm(cy[None])[0]
    lens_off = u_ax * (lr * np.cos(lth))[:, None] + v_ax * (lr * np.sin(lth))[:, None]
    p_focus = pos + dir_pinhole * focus
    o = (pos + lens_off).astype(np.float32)
    d = _norm(p_focus - o)

    tp = np.ones((n, 3), np.float32)
    rad = np.zeros((n, 3), np.float32)
    alive = np.ones(n, bool)
    prev_spec = np.ones(n, bool)

    v0, v1, v2 = ar.tri_v0, ar.tri_v1, ar.tri_v2
    bw = baldwin_rows(v0, v1, v2) if cfg.leaf_isect == "bw" else None
    lcount = ar.num_lights

    for depth in range(cfg.max_depth):
        if not alive.any():
            break
        t, hid = _intersect_brute(v0, v1, v2, o, d, bw=bw)
        alive = alive & (hid >= 0)
        sid = np.maximum(hid, 0)
        x_hit = o + d * t[:, None]

        e1 = v1[sid] - v0[sid]
        e2 = v2[sid] - v0[sid]
        nrm = _norm(_cross(e1, e2))
        nl = np.where((_dot(nrm, d) < 0)[:, None], nrm, -nrm)

        albedo = ar.albedo[sid].copy()
        emission = ar.emission[sid]
        metallic = ar.metallic[sid]
        roughness = ar.roughness[sid]
        transmission = ar.transmission[sid]
        ior = ar.ior[sid]

        # Planar texture mapping (renderer.cu:463-481).
        tex_id = ar.tex_id[sid]
        if len(textures) and (tex_id >= 0).any():
            scale = F32(cfg.tex_planar_scale)
            ny = np.abs(nrm[:, 1])
            nx = np.abs(nrm[:, 0])
            y_dom = ny > 0.9
            x_dom = (~y_dom) & (nx > 0.9)
            uu = np.where(y_dom, x_hit[:, 0], np.where(x_dom, x_hit[:, 2], x_hit[:, 0]))
            vv = np.where(y_dom, x_hit[:, 2], np.where(x_dom, x_hit[:, 1], x_hit[:, 1]))
            uu = uu * scale
            vv = 1.0 - vv * scale
            # Interpolated per-vertex UVs where present (flag-gated,
            # mirrors both engines; sliver fallback to planar).
            if cfg.uv_mapping and ar.uv_mask is not None and ar.uv_mask.max(initial=0.0) > 0:
                b1, b2, okb = _barycentric(v0[sid], v1[sid], v2[sid],
                                           x_hit)
                a0, a1, a2 = ar.uv0[sid], ar.uv1[sid], ar.uv2[sid]
                b0 = 1.0 - b1 - b2
                iu = a0[:, 0] * b0 + a1[:, 0] * b1 + a2[:, 0] * b2
                iv = a0[:, 1] * b0 + a1[:, 1] * b1 + a2[:, 1] * b2
                use_uv = (ar.uv_mask[sid] > 0) & okb
                uu = np.where(use_uv, iu, uu)
                vv = np.where(use_uv, 1.0 - iv, vv)
            for k, tex in enumerate(textures):
                mask = tex_id == k
                if mask.any():
                    albedo[mask] *= _bilinear_wrap(tex, uu[mask], vv[mask])

        # Smooth shading (flag-gated, mirrors both engines): ray
        # offsets keep the geometric front-face normal; directions use
        # the interpolated vertex normal.
        nl_off = nl
        if cfg.smooth_shading and ar.nrm0 is not None:
            nrm = _smooth_normal(v0[sid], v1[sid], v2[sid],
                                 ar.nrm0[sid], ar.nrm1[sid],
                                 ar.nrm2[sid], x_hit, nrm)
            nl = np.where((_dot(nrm, d) < 0)[:, None], nrm, -nrm)

        rad = rad + np.where((alive & prev_spec)[:, None], tp * emission, 0)
        is_emitter = (emission > cfg.emitter_stop_threshold).any(axis=-1)
        alive = alive & ~is_emitter

        # --- weights (renderer.cu:502-556) ---
        supp = (1.0 - metallic) ** 2
        spec_att = np.maximum(1.0 - roughness * roughness, 0.0)
        f0 = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]
        cos_th = np.maximum(_dot(nl, -d), 0.0)
        fres = f0 + (1.0 - f0) * ((1.0 - cos_th) ** 5)[:, None]
        f_avg = fres.mean(axis=-1)
        lum_a = albedo.max(axis=-1)
        w_spec = f_avg * spec_att
        w_trans = (1.0 - f_avg) * transmission
        w_diff = (1.0 - f_avg) * (1.0 - transmission) * supp * lum_a
        total = w_spec + w_trans + w_diff
        total = np.where(total < 1e-5, 1.0, total)
        p_spec = w_spec / total
        p_trans = w_trans / total

        base = CAMERA_DRAWS + depth * DRAWS_PER_BOUNCE
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            # --- russian roulette (renderer.cu:559-565) ---
            u_rr = U(base + SLOT_RR)
            if depth > cfg.rr_threshold:
                p = np.maximum(lum_a, cfg.rr_min_p)
                survive = u_rr < p
                tp = np.where((alive & survive)[:, None], tp / p[:, None], tp)
                alive = alive & survive

            u_b = U(base + SLOT_BRANCH)
            m_spec = alive & (u_b < p_spec)
            m_trans = alive & ~m_spec & (u_b < p_spec + p_trans)
            m_diff = alive & ~m_spec & ~m_trans
            u_d1 = U(base + SLOT_DIR_R1)
            u_d2 = U(base + SLOT_DIR_R2)
            sphere = _sample_sphere(u_d1, u_d2)

            # Branch A: specular.
            perfect = d - nrm * (2.0 * _dot(nrm, d))[:, None]
            d_spec = _norm(perfect + sphere * roughness[:, None])
            kill_spec = _dot(d_spec, nl) <= 0
            tp_spec = tp * fres / p_spec[:, None]
            o_spec = x_hit + nl_off * F32(cfg.shadow_eps)

            # Branch B: transmission.
            into = _dot(nrm, nl) > 0
            nnt = np.where(into, 1.0 / ior, ior)
            ddn = _dot(d, nl)
            cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
            tir = cos2t < 0
            d_tir = _norm(perfect + sphere * roughness[:, None])
            sign = np.where(into, 1.0, -1.0)
            coeff = sign * (ddn * nnt + np.sqrt(np.maximum(cos2t, 0.0)))
            tdir = _norm(d * nnt[:, None] - nrm * coeff[:, None])
            tdir = np.where((roughness > 0)[:, None],
                            _norm(tdir + sphere * roughness[:, None]), tdir)
            d_trans = np.where(tir[:, None], d_tir, tdir).astype(np.float32)
            p_branch = (1.0 - p_spec) * transmission
            tp_trans = np.where((p_branch > 1e-4)[:, None],
                                tp * albedo / p_branch[:, None], tp)
            o_trans = x_hit + d_trans * F32(cfg.refr_offset)

            # Branch C: diffuse + NEE (renderer.cu:651-733).
            if lcount > 0:
                u4 = U(base + SLOT_LIGHT_PICK)
                u5 = U(base + SLOT_LIGHT_R1)
                u6 = U(base + SLOT_LIGHT_R2)
                pick = np.clip((u4 * (lcount - 0.001)).astype(np.int32), 0, lcount - 1)
                li = ar.light_indices[pick]
                lv0, lv1, lv2 = v0[li], v1[li], v2[li]
                sqr1 = np.sqrt(u5)
                ba = 1.0 - sqr1
                bb = sqr1 * (1.0 - u6)
                lpos = lv0 * ba[:, None] + lv1 * bb[:, None] + lv2 * (1.0 - ba - bb)[:, None]
                to_l = lpos - x_hit
                dist_sq = _dot(to_l, to_l)
                if cfg.nee_dist_floor_enabled:
                    dist_sq = np.maximum(dist_sq, cfg.nee_dist_sq_floor)
                dist = np.sqrt(dist_sq)
                l_dir = (to_l / dist[:, None]).astype(np.float32)
                cos_t = _dot(nl, l_dir)
                light_n = _norm(_cross(lv1 - lv0, lv2 - lv0))
                cos_l = -_dot(light_n, l_dir)
                geo = m_diff & (cos_t > 0) & (cos_l > 0)
                occ = _occluded_brute(v0, v1, v2,
                                      x_hit + nl_off * F32(cfg.shadow_eps),
                                      l_dir, dist - F32(cfg.shadow_max_dist_eps), geo,
                                      bw=bw)
                lit = geo & ~occ
                area = 0.5 * np.sqrt((_cross(lv1 - lv0, lv2 - lv0) ** 2).sum(-1))
                pdf = 1.0 / (area * lcount)
                g = (cos_t * cos_l) / dist_sq
                contrib = ar.emission[li] * (albedo / PI) * (g / pdf)[:, None]
                rad = rad + np.where(lit[:, None], tp * contrib, 0)

            r1h = F32(2 * np.pi) * u_d1
            r2h = u_d2
            r2s = np.sqrt(r2h)
            w = nl
            pick_t = (np.abs(w[:, 0]) > 0.1)[:, None]
            tmp = np.where(pick_t, np.array([0, 1, 0], np.float32),
                           np.array([1, 0, 0], np.float32))
            u_ax2 = _norm(_cross(tmp, w))
            v_ax2 = _cross(w, u_ax2)
            d_diff = _norm(u_ax2 * (np.cos(r1h) * r2s)[:, None]
                           + v_ax2 * (np.sin(r1h) * r2s)[:, None]
                           + w * np.sqrt(np.maximum(1.0 - r2h, 0.0))[:, None])
            p_diff = 1.0 - p_spec - (1.0 - p_spec) * transmission
            tp_diff = tp * (albedo * (1.0 - metallic)[:, None]) / p_diff[:, None]
            o_diff = x_hit + nl_off * F32(cfg.shadow_eps)

            # --- select ---
            ms, mt, md = m_spec[:, None], m_trans[:, None], m_diff[:, None]
            d = np.where(ms, d_spec, np.where(mt, d_trans, d_diff)).astype(np.float32)
            o = np.where(ms, o_spec, np.where(mt, o_trans, o_diff)).astype(np.float32)
            tp = np.where(ms, tp_spec, np.where(mt, tp_trans,
                          np.where(md, tp_diff, tp))).astype(np.float32)
            alive = alive & ~(m_spec & kill_spec)
            prev_spec = np.where(m_spec | m_trans, True,
                                 np.where(m_diff, False, prev_spec))

    # --- sanitize (renderer.cu:737-756) ---
    bad = (np.isnan(rad) | np.isinf(rad)).any(axis=-1)
    rad = np.where(bad[:, None], 0, rad)
    rad = np.maximum(rad, 0)
    if cfg.clamp_fireflies:
        lum = rad[:, 0] * F32(0.21) + rad[:, 1] * F32(0.71) + rad[:, 2] * F32(0.07)
        over = lum > cfg.firefly_clamp
        scale = np.where(over, cfg.firefly_clamp / np.where(over, lum, 1), 1)
        rad = rad * scale[:, None]
    return rad.astype(np.float32)


def _bilinear_wrap(tex, u, v):
    h, w = tex.shape[:2]
    uf = u - np.floor(u)
    vf = v - np.floor(v)
    x = uf * w - 0.5
    y = vf * h - 0.5
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.astype(np.int32) % w
    y0i = y0.astype(np.int32) % h
    x1i = (x0i + 1) % w
    y1i = (y0i + 1) % h
    c00 = tex[y0i, x0i]
    c10 = tex[y0i, x1i]
    c01 = tex[y1i, x0i]
    c11 = tex[y1i, x1i]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)

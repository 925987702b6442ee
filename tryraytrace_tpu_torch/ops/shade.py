"""PBR shading math on torch tensors: Fresnel, branch weights and
direction sampling.

The counterpart of tryraytrace_tpu/ops/shade.py, with the same
reference parity targets:
  - fresnel_schlick                renderer.cu:201-204
  - sample_rough_reflection        renderer.cu:207-227
  - energy-weight branch selection renderer.cu:502-556
  - specular branch                renderer.cu:571-589
  - refraction + TIR               renderer.cu:592-648
  - cosine-hemisphere diffuse      renderer.cu:713-733
All three exclusive BSDF branches are evaluated and selected by mask.

``surface`` and ``scatter`` are the shading block both engines run on
a hit (engine/wavefront.py ``_bounce``, engine/persistent.py
``_shade_prepare`` / ``_shade_finish``): the hit's frame and material,
then the emission, roulette, branch and NEE arithmetic.  Each engine
keeps only what differs: where the hit row and the draws come from,
how a texture is sampled, and how the NEE segment is walked.
"""

from __future__ import annotations

import numpy as np
import torch

from tryraytrace_tpu_torch.core import rng, vec
from tryraytrace_tpu_torch.ops.texture import interp_uv, planar_uv

PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0) * np.float32(np.pi))
# 1/pi as the JAX engines evaluate it: a float32 division.
INV_PI = float(np.float32(1.0) / np.float32(np.pi))


def fresnel_schlick(cosine, f0):
    """F = F0 + (1-F0) * (1-cos)^5  [renderer.cu:201-204]."""
    return f0 + (1.0 - f0) * vec.pow(1.0 - cosine, 5.0)[..., None]


def pbr_weights(albedo, metallic, roughness, transmission, nl, r_d):
    """Energy-based branch probabilities (renderer.cu:509-556):
    returns (p_spec, p_trans, F) with the reference's heuristics and
    its sum < 1e-5 -> force-diffuse fallback."""
    diffuse_suppression = vec.pow(1.0 - metallic, 2.0)
    spec_attenuation = torch.clamp(1.0 - roughness * roughness, min=0.0)

    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    cos_theta = torch.clamp(vec.dot(nl, -r_d), min=0.0)
    f = fresnel_schlick(cos_theta, f0)
    f_avg = (f[..., 0] + f[..., 1] + f[..., 2]) / vec.scalar(3.0, f)

    albedo_lum = albedo.amax(dim=-1)
    w_spec = f_avg * spec_attenuation
    w_trans = (1.0 - f_avg) * transmission
    w_diff = ((1.0 - f_avg) * (1.0 - transmission) * diffuse_suppression
              * albedo_lum)

    total = w_spec + w_trans + w_diff
    degenerate = total < 1e-5
    total = torch.where(degenerate, 1.0, total)
    return w_spec / total, w_trans / total, f


def sample_unit_sphere(u1, u2):
    """Uniform unit-sphere direction (renderer.cu:222-224)."""
    r1 = u1 * TWO_PI
    z = 1.0 - 2.0 * u2
    r = vec.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * vec.cos(r1), r * vec.sin(r1), z], dim=-1)


def rough_perturb(direction, roughness, u1, u2):
    """(direction + sphere * roughness).norm()  [renderer.cu:226]."""
    sphere = sample_unit_sphere(u1, u2)
    return vec.norm(direction + sphere * roughness[..., None])


def reflect(d, n):
    """Mirror reflection r = d - 2 n (n.d)  [renderer.cu:573]."""
    return d - n * (2.0 * vec.dot(n, d))[..., None]


def refract_branch(r_d, n, nl, ior, roughness, u1, u2):
    """Transmission branch geometry (renderer.cu:592-636): returns
    (new_dir [N, 3], tir [N]).  TIR lanes reflect and perturb;
    refracting lanes apply Snell's law, then perturb when roughness > 0.
    Both sub-paths consume the same two uniforms."""
    into = vec.dot(n, nl) > 0.0
    nnt = torch.where(into, 1.0 / ior, ior)
    ddn = vec.dot(r_d, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0

    dir_tir = rough_perturb(reflect(r_d, n), roughness, u1, u2)

    sign = torch.where(into, 1.0, -1.0)
    coeff = sign * (ddn * nnt + vec.sqrt(torch.clamp(cos2t, min=0.0)))
    tdir = vec.norm(r_d * nnt[..., None] - n * coeff[..., None])
    tdir_rough = rough_perturb(tdir, roughness, u1, u2)
    tdir = torch.where((roughness > 0.0)[..., None], tdir_rough, tdir)
    return torch.where(tir[..., None], dir_tir, tdir), tir


def cosine_hemisphere(nl, u1, u2):
    """Cosine-weighted hemisphere around nl (renderer.cu:716-723), with
    the reference's |w.x| > 0.1 tangent pick."""
    r1 = TWO_PI * u1
    r2s = vec.sqrt(u2)
    w = nl
    # temp = (0, 1, 0) where |w.x| > 0.1, else (1, 0, 0).
    pick = (torch.abs(w[..., 0]) > 0.1).to(w.dtype)
    temp = torch.stack([1.0 - pick, pick, torch.zeros_like(pick)], dim=-1)
    u_axis = vec.norm(vec.cross(temp, w))
    v_axis = vec.cross(w, u_axis)
    d = (u_axis * (vec.cos(r1) * r2s)[..., None]
         + v_axis * (vec.sin(r1) * r2s)[..., None]
         + w * vec.sqrt(torch.clamp(1.0 - u2, min=0.0))[..., None])
    return vec.norm(d)


def triangle_area(v0, v1, v2):
    """0.5 * |e1 x e2|  [renderer.cu:188-192]."""
    return vec.length(vec.cross(v1 - v0, v2 - v0)) * 0.5


def sample_triangle(v0, v1, v2, u1, u2):
    """Uniform point on a triangle (renderer.cu:663-669)."""
    sqr1 = vec.sqrt(u1)
    a = 1.0 - sqr1
    b = sqr1 * (1.0 - u2)
    c = 1.0 - a - b
    return v0 * a[..., None] + v1 * b[..., None] + v2 * c[..., None]


def barycentric(v0, v1, v2, x_hit):
    """Barycentric (b1, b2, ok) of ``x_hit``; ``ok`` is False for
    ill-conditioned (near-sliver) triangles."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = x_hit - v0
    d11 = vec.dot(e1, e1)
    d12 = vec.dot(e1, e2)
    d22 = vec.dot(e2, e2)
    dp1 = vec.dot(p, e1)
    dp2 = vec.dot(p, e2)
    den = d11 * d22 - d12 * d12
    ok_den = den > 1e-6 * d11 * d22
    inv = 1.0 / torch.where(ok_den, den, 1.0)
    b1 = (d22 * dp1 - d12 * dp2) * inv
    b2 = (d11 * dp2 - d12 * dp1) * inv
    return b1, b2, ok_den


def smooth_normal(v0, v1, v2, n0, n1, n2, x_hit, nrm_geo):
    """Barycentric-interpolated vertex normal, oriented into the
    geometric normal's hemisphere; falls back to ``nrm_geo`` for
    triangles without normals or with a degenerate basis."""
    b1, b2, ok_den = barycentric(v0, v1, v2, x_hit)
    b0 = 1.0 - b1 - b2
    ns = n0 * b0[..., None] + n1 * b1[..., None] + n2 * b2[..., None]
    ns = torch.where(vec.dot(ns, nrm_geo)[..., None] < 0.0, -ns, ns)
    len2 = vec.dot(ns, ns)
    ok = ok_den & (len2 > 1e-12)
    ns = ns / vec.sqrt(torch.where(ok, len2, 1.0))[..., None]
    return torch.where(ok[..., None], ns, nrm_geo)


def surface(hitrow, x_hit, d, scene, cfg, textured: bool):
    """The hit's shading frame and material from its triangle row
    (renderer.cu:441-481) -> (q, uv).  ``q`` holds x_hit, nrm (the face
    normal, or with smooth shading on the interpolated vertex normal),
    nl (nrm turned against ``d``), nl_off (the geometric front-face
    normal that ray offsets keep) and the material's albedo, emission,
    metallic, roughness, ior and transmission.  ``uv`` is the texture
    coordinates (t_u, t_v) when ``textured`` (planar projection, or
    interpolated per-corner UVs where the triangle has them with UV
    mapping on), else None; the caller samples the texture."""
    v0 = hitrow[:, 0:3]
    v1 = hitrow[:, 3:6]
    v2 = hitrow[:, 6:9]
    nrm = vec.norm(vec.cross(v1 - v0, v2 - v0))
    nl = torch.where((vec.dot(nrm, d) < 0.0)[:, None], nrm, -nrm)

    uv = None
    if textured:
        t_u, t_v = planar_uv(x_hit, nrm, cfg.tex_planar_scale)
        if cfg.uv_mapping and scene.has_uvs:
            b1, b2, okb = barycentric(v0, v1, v2, x_hit)
            iu, iv = interp_uv(hitrow[:, 30:36], b1, b2)
            use_uv = (hitrow[:, 36] > 0.0) & okb
            t_u = torch.where(use_uv, iu, t_u)
            t_v = torch.where(use_uv, iv, t_v)
        uv = (t_u, t_v)

    nl_off = nl
    if cfg.smooth_shading and scene.has_normals:
        nrm = smooth_normal(v0, v1, v2, hitrow[:, 21:24], hitrow[:, 24:27],
                            hitrow[:, 27:30], x_hit, nrm)
        nl = torch.where((vec.dot(nrm, d) < 0.0)[:, None], nrm, -nrm)

    q = dict(x_hit=x_hit, nrm=nrm, nl=nl, nl_off=nl_off,
             albedo=hitrow[:, 9:12], emission=hitrow[:, 12:15],
             metallic=hitrow[:, 15], roughness=hitrow[:, 16],
             ior=hitrow[:, 17], transmission=hitrow[:, 18])
    return q, uv


def scatter(q, d, tp, rad, alive, prev_spec, u, rr_on, scene, cfg) -> dict:
    """The RNG/branch half of the shading block (renderer.cu:486-733) for
    the hits ``alive``, with ``q`` from ``surface`` and ``u`` [N, 7] the
    bounce's draws (core/rng.py slots):
      - emission, added only after a specular or refractive bounce (the
        NEE double-count guard); an emitter ends the path;
      - Russian roulette where ``rr_on`` (bool, broadcast over lanes);
      - the exclusive spec/trans/diff branch select, each branch's next
        ray and throughput (the unguarded 1/p of the reference: a
        selected lane with p = 0 gets inf, and the sanitation drops its
        sample), a specular ray below the surface ends the path;
      - the NEE light sample of the diffuse lanes, with the reference's
        quirks: the dist^2 >= 5 floor (renderer.cu:674), and L_dir from
        the unclamped vector over the clamped distance.
    Returns rad, alive, o, d, tp, prev_spec (the next ray's; tp stays for
    lanes in no branch) and ``nee``: None without lights, else
    (shadow-ray lanes, origin, direction, max distance, tp x the light's
    contribution if unoccluded)."""
    x_hit, nrm, nl, nl_off = q["x_hit"], q["nrm"], q["nl"], q["nl_off"]
    albedo, emission = q["albedo"], q["emission"]
    metallic, roughness = q["metallic"], q["roughness"]
    transmission = q["transmission"]

    rad = rad + torch.where((alive & prev_spec)[:, None], tp * emission,
                            0.0)
    is_emitter = (emission > cfg.emitter_stop_threshold).any(dim=-1)
    alive = alive & ~is_emitter

    p_spec, p_trans, fres = pbr_weights(albedo, metallic, roughness,
                                        transmission, nl, d)

    # Russian roulette (renderer.cu:559-565).
    p_live = torch.clamp(albedo.amax(dim=-1), min=cfg.rr_min_p)
    survive = u[:, rng.SLOT_RR] < p_live
    tp = torch.where((rr_on & alive & survive)[:, None],
                     tp * (1.0 / p_live)[:, None], tp)
    alive = alive & (~rr_on | survive)

    # Exclusive branch selection (renderer.cu:567-571,592,651).
    u_b = u[:, rng.SLOT_BRANCH]
    m_spec = alive & (u_b < p_spec)
    m_trans = alive & ~m_spec & (u_b < p_spec + p_trans)
    m_diff = alive & ~m_spec & ~m_trans
    u_d1 = u[:, rng.SLOT_DIR_R1]
    u_d2 = u[:, rng.SLOT_DIR_R2]
    o_off = x_hit + nl_off * cfg.shadow_eps

    # Branch A: specular (renderer.cu:571-589).
    d_spec = rough_perturb(reflect(d, nrm), roughness, u_d1, u_d2)
    kill_spec = vec.dot(d_spec, nl) <= 0.0
    tp_spec = tp * fres * (1.0 / p_spec)[:, None]

    # Branch B: transmission (renderer.cu:592-648).
    d_trans, _ = refract_branch(d, nrm, nl, q["ior"], roughness, u_d1, u_d2)
    p_branch = (1.0 - p_spec) * transmission
    tp_trans = torch.where(
        (p_branch > 1e-4)[:, None],
        tp * albedo / torch.where(p_branch > 1e-4, p_branch, 1.0)[:, None],
        tp)
    o_trans = x_hit + d_trans * cfg.refr_offset

    # Branch C: diffuse + NEE (renderer.cu:651-733).
    nee = None
    if scene.num_lights > 0:
        lcount = scene.num_lights
        lrows = scene.trimat[scene.light_indices[:lcount]]
        if lcount == 1:
            lrow = lrows[0].expand(u.shape[0], -1)
        else:
            pick = torch.clamp((u[:, rng.SLOT_LIGHT_PICK]
                                * (lcount - 0.001)).to(torch.int64),
                               0, lcount - 1)
            lrow = lrows[pick]
        lv0, lv1, lv2 = lrow[:, 0:3], lrow[:, 3:6], lrow[:, 6:9]
        light_pos = sample_triangle(lv0, lv1, lv2, u[:, rng.SLOT_LIGHT_R1],
                                    u[:, rng.SLOT_LIGHT_R2])
        to_light = light_pos - x_hit
        dist_sq = vec.dot(to_light, to_light)
        if cfg.nee_dist_floor_enabled:
            dist_sq = torch.clamp(dist_sq, min=cfg.nee_dist_sq_floor)
        dist = vec.sqrt(dist_sq)
        l_dir = to_light * (1.0 / dist)[:, None]
        cos_theta = vec.dot(nl, l_dir)
        light_n = vec.norm(vec.cross(lv1 - lv0, lv2 - lv0))
        cos_light = -vec.dot(light_n, l_dir)
        geo_ok = m_diff & (cos_theta > 0.0) & (cos_light > 0.0)

        area = lrow[:, 20]  # precomputed triangle area (renderer.cu:188-192)
        pdf = 1.0 / (area * lcount)
        g_term = (cos_theta * cos_light) / dist_sq
        contrib = lrow[:, 12:15] * (albedo * INV_PI) * (g_term / pdf)[:, None]
        nee = (geo_ok, o_off, l_dir, dist - cfg.shadow_max_dist_eps,
               tp * contrib)
    d_diff = cosine_hemisphere(nl, u_d1, u_d2)
    p_diff = 1.0 - p_spec - (1.0 - p_spec) * transmission  # renderer.cu:727
    tp_diff = (tp * (albedo * (1.0 - metallic)[:, None])
               * (1.0 / p_diff)[:, None])  # unguarded, renderer.cu:728

    ms3, mt3, md3 = m_spec[:, None], m_trans[:, None], m_diff[:, None]
    return dict(
        rad=rad,
        alive=alive & ~(m_spec & kill_spec),
        o=torch.where(ms3, o_off, torch.where(mt3, o_trans, o_off)),
        d=torch.where(ms3, d_spec, torch.where(mt3, d_trans, d_diff)),
        tp=torch.where(ms3, tp_spec, torch.where(
            mt3, tp_trans, torch.where(md3, tp_diff, tp))),
        prev_spec=torch.where(m_spec | m_trans, True,
                              torch.where(m_diff, False, prev_spec)),
        nee=nee)

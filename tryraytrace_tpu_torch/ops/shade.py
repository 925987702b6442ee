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
"""

from __future__ import annotations

import numpy as np
import torch

from tryraytrace_tpu_torch.core import vec

PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0) * np.float32(np.pi))


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

// The service pass's device code, shared by the service kernel
// (service_pass.cu: every lane served once, one launch a round) and the
// wave kernel (wave_advance.cu: each lane's walks and services to its
// budget, one launch a Wave.advance).  service_pass.cu's notes say what
// it computes, what bounds it on this card and what its design does
// about that.  Here: the parameter layout, the float rules (every
// product and sum rounded on its own, sums of three left to right, sqrt,
// pow, cos and sin in double rounded once), the SHADEG frame (prepare),
// the TEXG sample (texture_lane), the shade (finish), the refill and one
// lane's service in the eager order (serve).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace trt_service {

// Lane modes (ops/walk.py).
constexpr long long kTraverse = 0;
constexpr long long kShadow = 1;
constexpr long long kRefill = 3;
constexpr long long kDone = 4;
constexpr long long kShadeG = 5;
constexpr long long kTexG = 6;

constexpr int kThreads = 256;
constexpr float kMissT = 1e20f;  // ops/traverse.py MISS_T
// core/rng.py: draws per bounce, camera draws, the hash's constants.
constexpr unsigned kCameraDraws = 4u;
constexpr unsigned kDrawsPerBounce = 8u;
constexpr float kInv2p24 = 1.0f / 16777216.0f;
// Trimat row (accel/bvh.py pack_trimat_table): 37 floats.
constexpr int kTrimatRow = 37;
// Texture tiles (ops/texture.py).
constexpr long long kTexTile = 4;
constexpr long long kTexApron = kTexTile + 1;

// Float parameters, in the order of ops/service.py FLOATS.
enum FloatParam {
  kCamPos = 0, kCamCx = 3, kCamCy = 6, kCamDir = 9, kLensRadius = 12,
  kFocusDist = 13, kWidthF = 14, kHeightF = 15, kRrMinP = 16,
  kEmitterStop = 17, kShadowEps = 18, kRefrOffset = 19,
  kShadowMaxDistEps = 20, kNeeDistSqFloor = 21, kFireflyClamp = 22,
  kTexPlanarScale = 23, kLightPickScale = 24, kLightCountF = 25,
  kTwoPi = 26, kInvPi = 27, kNumFloats = 28
};
// Integer parameters, in the order of ops/service.py INTS.
enum IntParam {
  kWidth = 0, kHeight = 1, kSppCap = 2, kSeedBase = 3, kSampleOffset = 4,
  kSentinel = 5, kPack = 6, kTex0 = 7, kNumTex = 8, kNumLights = 9,
  kRrThreshold = 10, kMaxDepth = 11, kNeeFloorOn = 12,
  kClampFireflies = 13, kSmooth = 14, kUv = 15, kTableRows = 16,
  kTableWidth = 17, kNumInts = 18
};
// Pointers, in the order ops/service.py service_pass_cuda packs them.
enum PtrParam {
  kTable = 0, kLights, kMetas, kMode, kCur, kHitId, kDepth, kSample, kSeed,
  kPix, kDMin, kO, kD, kTp, kRad, kSo, kSd, kSmax, kPend, kOut, kTstash,
  kPrevSpec, kContAfterShadow, kTotals, kNumPtrs
};
// The wave's int64 totals (ops/service.py TOTALS): path rays started,
// shadow rays fired, and the two live-lane slots.
enum Total { kPathRays = 0, kShadowRays = 1, kLive = 2, kNumTotals = 4 };

struct Params {
  float f[kNumFloats];
  long long i[kNumInts];
  const float* table;
  const float* lights;        // [n_lights, 37] trimat rows of the lights
  const long long* metas;     // [n_tex, 4] (offset, tiles_x, w, h)
  long long* mode;
  long long* cur;
  long long* hit_id;
  long long* depth;
  long long* sample;
  long long* seed;
  const long long* pix;
  float* d_min;
  float* o;
  float* d;
  float* tp;
  float* rad;
  float* so;
  float* sd;
  float* smax;
  float* pend;
  float* out;
  float* tstash;              // [n, 10], null without textures
  unsigned char* prev_spec;
  unsigned char* cont_after_shadow;
  unsigned long long* totals;  // Total
  long long n;
  int slot;                    // this round's live-lane slot, 0 or 1
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
// core/vec.py dot: (x0 + x1) + x2 of the products.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const V3 p = mul(a, b);
  return p.x + p.y + p.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
// core/vec.py sqrt / pow / cos / sin: float64, rounded once.
__device__ __forceinline__ float sqrt64(float x) {
  return static_cast<float>(sqrt(static_cast<double>(x)));
}
__device__ __forceinline__ float cos64(float x) {
  return static_cast<float>(cos(static_cast<double>(x)));
}
__device__ __forceinline__ float sin64(float x) {
  return static_cast<float>(sin(static_cast<double>(x)));
}
// torch's pow by 2 squares in float64 (exact); by 5 it calls pow.
__device__ __forceinline__ float square64(float x) {
  const double v = static_cast<double>(x);
  return static_cast<float>(v * v);
}
__device__ __forceinline__ float pow5_64(float x) {
  return static_cast<float>(pow(static_cast<double>(x), 5.0));
}
// core/vec.py norm: multiply by the reciprocal length; a zero (or NaN)
// length multiplies by 1.
__device__ __forceinline__ V3 norm(V3 a) {
  const float len = sqrt64(dot(a, a));
  const bool pos = len > 0.0f;
  const float inv = pos ? 1.0f / len : 1.0f;
  return scale(a, inv);
}
// torch.clamp(x, min=lo) keeps a NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
// amax over three: NaN if any is NaN.
__device__ __forceinline__ float max3(V3 a) {
  float m = a.x;
  if (a.y > m || a.y != a.y) m = a.y;
  if (a.z > m || a.z != a.z) m = a.z;
  if (a.x != a.x) m = a.x;
  return m;
}
__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 row3(const float* row, int c) {
  return v3(row[c], row[c + 1], row[c + 2]);
}

// core/rng.py: the PCG output permutation, hash3 and uniform, in uint32.
__device__ __forceinline__ unsigned pcg(unsigned x) {
  const unsigned state = x * 747796405u + 2891336453u;
  const unsigned word = ((state >> ((state >> 28u) + 4u)) ^ state) *
                        277803737u;
  return (word >> 22u) ^ word;
}
__device__ __forceinline__ float uniform(unsigned seed, unsigned stream,
                                         unsigned draw) {
  const unsigned h = pcg(seed + pcg(stream + pcg(draw)));
  return static_cast<float>(h >> 8u) * kInv2p24;
}

// The shading frame and material of a hit (ops/shade.py surface and
// _shade_prepare's inputs to scatter).
struct Surface {
  V3 x_hit, nrm, nl, nl_off, albedo, emission;
  float metallic, roughness, ior, transmission;
};

// ops/shade.py barycentric.
__device__ __forceinline__ void barycentric(V3 v0, V3 v1, V3 v2, V3 x,
                                            float* b1, float* b2, bool* ok) {
  const V3 e1 = sub(v1, v0);
  const V3 e2 = sub(v2, v0);
  const V3 p = sub(x, v0);
  const float d11 = dot(e1, e1);
  const float d12 = dot(e1, e2);
  const float d22 = dot(e2, e2);
  const float dp1 = dot(p, e1);
  const float dp2 = dot(p, e2);
  const float den = d11 * d22 - d12 * d12;
  *ok = den > 1e-6f * d11 * d22;
  const float inv = 1.0f / (*ok ? den : 1.0f);
  *b1 = (d22 * dp1 - d12 * dp2) * inv;
  *b2 = (d11 * dp2 - d12 * dp1) * inv;
}

// ops/shade.py sample_unit_sphere and rough_perturb.
__device__ __forceinline__ V3 rough_perturb(V3 dir, float roughness,
                                            float u1, float u2,
                                            float two_pi) {
  const float r1 = u1 * two_pi;
  const float z = 1.0f - 2.0f * u2;
  const float r = sqrt64(clamp_min(1.0f - z * z, 0.0f));
  const V3 sphere = v3(r * cos64(r1), r * sin64(r1), z);
  return norm(add(dir, scale(sphere, roughness)));
}

// ops/shade.py reflect.
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  return sub(d, scale(n, 2.0f * dot(n, d)));
}

// ops/shade.py refract_branch (the direction only), for a lane on the
// transmission branch: on total internal reflection the specular
// direction (scatter's d_spec), else the refracted one, perturbed only
// when roughness > 0.
__device__ __forceinline__ V3 refract_dir(V3 r_d, V3 n, V3 nl, float ior,
                                          float roughness, float u1,
                                          float u2, float two_pi) {
  const bool into = dot(n, nl) > 0.0f;
  const float nnt = into ? 1.0f / ior : ior;
  const float ddn = dot(r_d, nl);
  const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
  if (cos2t < 0.0f) {
    return rough_perturb(reflect(r_d, n), roughness, u1, u2, two_pi);
  }
  const float sign = into ? 1.0f : -1.0f;
  const float coeff = sign * (ddn * nnt + sqrt64(clamp_min(cos2t, 0.0f)));
  const V3 tdir = norm(sub(scale(r_d, nnt), scale(n, coeff)));
  if (roughness > 0.0f) {
    return rough_perturb(tdir, roughness, u1, u2, two_pi);
  }
  return tdir;
}

// ops/shade.py cosine_hemisphere.
__device__ __forceinline__ V3 cosine_hemisphere(V3 w, float u1, float u2,
                                                float two_pi) {
  const float r1 = two_pi * u1;
  const float r2s = sqrt64(u2);
  const float pick = fabsf(w.x) > 0.1f ? 1.0f : 0.0f;
  const V3 temp = v3(1.0f - pick, pick, 0.0f);
  const V3 u_axis = norm(cross(temp, w));
  const V3 v_axis = cross(w, u_axis);
  const V3 d = add(add(scale(u_axis, cos64(r1) * r2s),
                       scale(v_axis, sin64(r1) * r2s)),
                   scale(w, sqrt64(clamp_min(1.0f - u2, 0.0f))));
  return norm(d);
}

// engine/camera_rays.py generate_rays for pixel `pix` with sample seed
// `seed`.
__device__ __forceinline__ void camera_ray(const Params& p, long long pix,
                                           unsigned seed, V3* r_o,
                                           V3* r_d) {
  const long long width = p.i[kWidth];
  const float x = static_cast<float>(pix % width);
  const long long row = pix / width;
  const float y = static_cast<float>(p.i[kHeight] - 1 - row);
  const unsigned stream = static_cast<unsigned>(pix);
  const float u0 = uniform(seed, stream, 0u);
  const float u1 = uniform(seed, stream, 1u);
  const float u2 = uniform(seed, stream, 2u);
  const float u3 = uniform(seed, stream, 3u);
  const float r1 = 2.0f * u0;
  const float r2 = 2.0f * u1;
  const float dx = r1 < 1.0f ? sqrt64(r1) - 1.0f
                             : 1.0f - sqrt64(clamp_min(2.0f - r1, 0.0f));
  const float dy = r2 < 1.0f ? sqrt64(r2) - 1.0f
                             : 1.0f - sqrt64(clamp_min(2.0f - r2, 0.0f));
  const float sx = (x + 0.5f + dx) / p.f[kWidthF] - 0.5f;
  const float sy = (y + 0.5f + dy) / p.f[kHeightF] - 0.5f;
  const V3 pos = v3(p.f[kCamPos], p.f[kCamPos + 1], p.f[kCamPos + 2]);
  const V3 cx = v3(p.f[kCamCx], p.f[kCamCx + 1], p.f[kCamCx + 2]);
  const V3 cy = v3(p.f[kCamCy], p.f[kCamCy + 1], p.f[kCamCy + 2]);
  const V3 dir = v3(p.f[kCamDir], p.f[kCamDir + 1], p.f[kCamDir + 2]);
  const V3 dir_pinhole = norm(add(add(scale(cx, sx), scale(cy, sy)), dir));
  const float lr = p.f[kLensRadius] * sqrt64(u2);
  const float ltheta = p.f[kTwoPi] * u3;
  const V3 u_axis = norm(cx);
  const V3 v_axis = norm(cy);
  const V3 lens_offset = add(scale(u_axis, lr * cos64(ltheta)),
                             scale(v_axis, lr * sin64(ltheta)));
  const V3 p_focus = add(pos, scale(dir_pinhole, p.f[kFocusDist]));
  *r_o = add(pos, lens_offset);
  *r_d = norm(sub(p_focus, *r_o));
}

// SHADEG: the hit's frame and material from its trimat row (ops/shade.py
// surface).  Returns the frame; for a textured hit that must wait for
// its tile row, parks the lane in TEXG and returns false.
__device__ __forceinline__ bool prepare(const Params& p, long long i,
                                        Surface* q) {
  const long long hit = p.hit_id[i];
  const long long sid = hit < 0 ? 0 : hit;
  const long long r = p.i[kSentinel] + (p.i[kPack] == 2 ? sid >> 1 : sid);
  const int half = p.i[kPack] == 2 && (hit & 1) == 1 ? kTrimatRow : 0;
  const float* row = p.table + r * p.i[kTableWidth] + half;
  const bool textured = p.i[kTex0] >= 0;
  bool deferred = false;
  const float tex_f = row[19];
  if (textured) {
    deferred = hit >= 0 && tex_f >= 0.0f &&
               tex_f < static_cast<float>(p.i[kNumTex]);
  }
  const V3 d = load3(p.d, i);
  const V3 o = load3(p.o, i);
  const float d_min = p.d_min[i];
  q->x_hit = add(o, scale(d, d_min));
  const V3 v0 = row3(row, 0);
  const V3 v1 = row3(row, 3);
  const V3 v2 = row3(row, 6);
  const V3 nrm_geo = norm(cross(sub(v1, v0), sub(v2, v0)));
  V3 nrm = nrm_geo;
  V3 nl = dot(nrm, d) < 0.0f ? nrm : neg(nrm);
  const bool smooth = p.i[kSmooth] != 0;
  // One barycentric serves the smooth normal and the UVs; the UVs are
  // needed only by a hit parked for its texture, on a triangle with UVs.
  const bool uv = deferred && p.i[kUv] && row[36] > 0.0f;
  float b1 = 0.0f, b2 = 0.0f;
  bool okb = false;
  if (smooth || uv) barycentric(v0, v1, v2, q->x_hit, &b1, &b2, &okb);
  const V3 nl_off = nl;
  if (smooth) {
    // ops/shade.py smooth_normal.
    const float b0 = 1.0f - b1 - b2;
    V3 ns = add(add(scale(row3(row, 21), b0), scale(row3(row, 24), b1)),
                scale(row3(row, 27), b2));
    ns = dot(ns, nrm) < 0.0f ? neg(ns) : ns;
    const float len2 = dot(ns, ns);
    const bool ok = okb && len2 > 1e-12f;
    if (ok) {
      const float len = sqrt64(len2);
      nrm = v3(ns.x / len, ns.y / len, ns.z / len);
    }
    nl = dot(nrm, d) < 0.0f ? nrm : neg(nrm);
  }
  q->nrm = nrm;
  q->nl = nl;
  q->nl_off = nl_off;
  q->albedo = row3(row, 9);
  q->emission = row3(row, 12);
  q->metallic = row[15];
  q->roughness = row[16];
  q->ior = row[17];
  q->transmission = row[18];
  if (!deferred) return true;

  // ops/texture.py planar_uv (on the face normal), or interp_uv where
  // the triangle has UVs.
  const float nx = fabsf(nrm_geo.x);
  const float ny = fabsf(nrm_geo.y);
  const bool y_dom = ny > 0.9f;
  const bool x_dom = !y_dom && nx > 0.9f;
  const V3 xh = q->x_hit;
  float t_u = y_dom ? xh.x : (x_dom ? xh.z : xh.x);
  float t_v = y_dom ? xh.z : (x_dom ? xh.y : xh.y);
  t_u = t_u * p.f[kTexPlanarScale];
  t_v = 1.0f - t_v * p.f[kTexPlanarScale];
  if (uv && okb) {
    const float b0 = 1.0f - b1 - b2;
    t_u = row[30] * b0 + row[32] * b1 + row[34] * b2;
    t_v = 1.0f - (row[31] * b0 + row[33] * b1 + row[35] * b2);
  }

  // TEXG: ops/texture.py tile_coords for this lane's texture, then the
  // stash (_shade_prepare); nrm is rebuilt from nl and the front bit.
  const bool front = dot(nrm, d) < 0.0f;
  const long long tid = static_cast<long long>(tex_f);
  const long long* m = p.metas + 4 * tid;
  const long long w = m[2], h = m[3];
  const float x = (t_u - floorf(t_u)) * static_cast<float>(w) - 0.5f;
  const float y = (t_v - floorf(t_v)) * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  // torch's % of int64 is a floor modulo: -1 % w is w - 1.
  const long long x0i = ((static_cast<long long>(x0) % w) + w) % w;
  const long long y0i = ((static_cast<long long>(y0) % h) + h) % h;
  const long long tx = x0i / kTexTile;
  const long long ty = y0i / kTexTile;
  const long long trow = m[0] + ty * m[1] + tx;
  const long long offx = x0i - tx * kTexTile;
  const long long offy = y0i - ty * kTexTile;
  store3(p.so, i, nl);
  store3(p.sd, i, nl_off);
  store3(p.pend, i, q->emission);
  float* ts = p.tstash + 10 * i;
  ts[0] = q->albedo.x;
  ts[1] = q->albedo.y;
  ts[2] = q->albedo.z;
  ts[3] = q->metallic;
  ts[4] = q->roughness;
  ts[5] = q->ior;
  ts[6] = q->transmission;
  ts[7] = x - x0;
  ts[8] = y - y0;
  ts[9] = front ? 1.0f : 0.0f;
  p.mode[i] = kTexG;
  p.cur[i] = p.i[kTex0] + trow;
  p.hit_id[i] = offy * kTexTile + offx;
  return false;
}

// TEXG: the frame and material from the stash and the tile row at cur
// (_service_shade's overrides, ops/texture.py tile_bilinear).
__device__ __forceinline__ void texture_lane(const Params& p, long long i,
                                             Surface* q) {
  const V3 d = load3(p.d, i);
  const V3 o = load3(p.o, i);
  q->x_hit = add(o, scale(d, p.d_min[i]));
  const float* ts = p.tstash + 10 * i;
  const long long hit = p.hit_id[i] < 0 ? 0 : p.hit_id[i];
  const long long offx = hit % kTexTile;
  const long long offy = hit / kTexTile % kTexTile;
  const float* row = p.table + p.cur[i] * p.i[kTableWidth];
  const long long base = (offy * kTexApron + offx) * 3;
  const V3 c00 = row3(row, static_cast<int>(base));
  const V3 c10 = row3(row, static_cast<int>(base + 3));
  const V3 c01 = row3(row, static_cast<int>(base + kTexApron * 3));
  const V3 c11 = row3(row, static_cast<int>(base + kTexApron * 3 + 3));
  const float fx = ts[7], fy = ts[8];
  const V3 top = add(scale(c00, 1.0f - fx), scale(c10, fx));
  const V3 bot = add(scale(c01, 1.0f - fx), scale(c11, fx));
  const V3 factor = add(scale(top, 1.0f - fy), scale(bot, fy));
  const V3 nl_x = load3(p.so, i);
  const bool front = ts[9] > 0.0f;
  q->nl = nl_x;
  q->nrm = front ? nl_x : neg(nl_x);
  q->nl_off = load3(p.sd, i);
  q->albedo = mul(v3(ts[0], ts[1], ts[2]), factor);
  q->emission = load3(p.pend, i);
  q->metallic = ts[3];
  q->roughness = ts[4];
  q->ior = ts[5];
  q->transmission = ts[6];
}

// _shade_finish with ops/shade.py scatter and pbr_weights for a ready
// lane.  Sets *cont and *fire (path continues, shadow ray fired);
// returns whether the lane is left in REFILL.
__device__ __forceinline__ bool finish(const Params& p, long long i,
                                       const Surface& q, int* cont,
                                       int* fire) {
  const float two_pi = p.f[kTwoPi];
  const long long depth = p.depth[i];
  const unsigned seed = static_cast<unsigned>(p.seed[i]);
  const unsigned stream = static_cast<unsigned>(p.pix[i]);
  const unsigned base = kCameraDraws +
                        static_cast<unsigned>(depth) * kDrawsPerBounce;
  float u[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) u[k] = uniform(seed, stream, base + k);
  const V3 d = load3(p.d, i);
  V3 tp = load3(p.tp, i);
  V3 rad = load3(p.rad, i);
  const bool prev_spec = p.prev_spec[i] != 0;
  bool alive = p.hit_id[i] >= 0;  // a miss ends the path

  const V3 em = q.emission;
  const bool add_em = alive && prev_spec;
  rad = v3(rad.x + (add_em ? tp.x * em.x : 0.0f),
           rad.y + (add_em ? tp.y * em.y : 0.0f),
           rad.z + (add_em ? tp.z * em.z : 0.0f));
  const float thr = p.f[kEmitterStop];
  const bool is_emitter = em.x > thr || em.y > thr || em.z > thr;
  alive = alive && !is_emitter;

  const V3 albedo = q.albedo;
  const float metallic = q.metallic, roughness = q.roughness;
  const float transmission = q.transmission;
  const float albedo_lum = max3(albedo);
  const float u_d1 = u[2], u_d2 = u[3];
  const V3 o_off = add(q.x_hit, scale(q.nl_off, p.f[kShadowEps]));
  const long long lcount = p.i[kNumLights];

  // Russian roulette.
  const bool rr_on = depth > p.i[kRrThreshold];
  const float p_live = clamp_min(albedo_lum, p.f[kRrMinP]);
  const bool survive = u[0] < p_live;
  if (rr_on && alive && survive) tp = scale(tp, 1.0f / p_live);
  alive = alive && (!rr_on || survive);

  // What a lane in no branch keeps: its throughput and flag, the offset
  // origin, and (only if it retires in this pass) the diffuse direction.
  V3 new_o = o_off, new_d = d, new_tp = tp;
  bool new_prev = prev_spec, b_alive = alive, has_shadow = false;
  V3 nee_d = v3(0.0f, 0.0f, 0.0f), nee_tp = v3(0.0f, 0.0f, 0.0f);
  float nee_max = 0.0f;
  if (alive) {
    // pbr_weights.
    const float diffuse_suppression = square64(1.0f - metallic);
    const float spec_attenuation =
        clamp_min(1.0f - roughness * roughness, 0.0f);
    const float m1 = 1.0f - metallic;
    const V3 f0 = v3(0.04f * m1 + albedo.x * metallic,
                     0.04f * m1 + albedo.y * metallic,
                     0.04f * m1 + albedo.z * metallic);
    const float cos_theta_v = clamp_min(dot(q.nl, neg(d)), 0.0f);
    const float p5 = pow5_64(1.0f - cos_theta_v);
    const V3 fres = v3(f0.x + (1.0f - f0.x) * p5,
                       f0.y + (1.0f - f0.y) * p5,
                       f0.z + (1.0f - f0.z) * p5);
    const float f_avg = (fres.x + fres.y + fres.z) / 3.0f;
    const float w_spec = f_avg * spec_attenuation;
    const float w_trans = (1.0f - f_avg) * transmission;
    const float w_diff = (1.0f - f_avg) * (1.0f - transmission) *
                         diffuse_suppression * albedo_lum;
    float total = w_spec + w_trans + w_diff;
    total = total < 1e-5f ? 1.0f : total;
    const float p_spec = w_spec / total;
    const float p_trans = w_trans / total;

    // The exclusive branch.
    const float u_b = u[1];
    if (u_b < p_spec) {
      new_d = rough_perturb(reflect(d, q.nrm), roughness, u_d1, u_d2,
                            two_pi);
      b_alive = !(dot(new_d, q.nl) <= 0.0f);
      new_tp = scale(mul(tp, fres), 1.0f / p_spec);
      new_prev = true;
    } else if (u_b < p_spec + p_trans) {
      new_d = refract_dir(d, q.nrm, q.nl, q.ior, roughness, u_d1, u_d2,
                          two_pi);
      const float p_branch = (1.0f - p_spec) * transmission;
      const bool pb_ok = p_branch > 1e-4f;
      const float pb = pb_ok ? p_branch : 1.0f;
      const V3 ta = mul(tp, albedo);
      new_tp = pb_ok ? v3(ta.x / pb, ta.y / pb, ta.z / pb) : tp;
      new_o = add(q.x_hit, scale(new_d, p.f[kRefrOffset]));
      new_prev = true;
    } else {
      if (lcount > 0) {
        long long pick = 0;
        if (lcount > 1) {
          pick = static_cast<long long>(u[4] * p.f[kLightPickScale]);
          pick = pick < 0 ? 0 : (pick > lcount - 1 ? lcount - 1 : pick);
        }
        const float* lrow = p.lights + pick * kTrimatRow;
        const V3 lv0 = row3(lrow, 0);
        const V3 lv1 = row3(lrow, 3);
        const V3 lv2 = row3(lrow, 6);
        // sample_triangle.
        const float sqr1 = sqrt64(u[5]);
        const float a = 1.0f - sqr1;
        const float b = sqr1 * (1.0f - u[6]);
        const float c = 1.0f - a - b;
        const V3 light_pos = add(add(scale(lv0, a), scale(lv1, b)),
                                 scale(lv2, c));
        const V3 to_light = sub(light_pos, q.x_hit);
        float dist_sq = dot(to_light, to_light);
        if (p.i[kNeeFloorOn]) {
          dist_sq = clamp_min(dist_sq, p.f[kNeeDistSqFloor]);
        }
        const float dist = sqrt64(dist_sq);
        const V3 l_dir = scale(to_light, 1.0f / dist);
        const float cos_theta = dot(q.nl, l_dir);
        const V3 light_n = norm(cross(sub(lv1, lv0), sub(lv2, lv0)));
        const float cos_light = -dot(light_n, l_dir);
        has_shadow = cos_theta > 0.0f && cos_light > 0.0f;
        const float area = lrow[20];
        const float pdf = 1.0f / (area * p.f[kLightCountF]);
        const float g_term = (cos_theta * cos_light) / dist_sq;
        const float gp = g_term / pdf;
        const V3 brdf = scale(albedo, p.f[kInvPi]);
        const V3 contrib = scale(mul(row3(lrow, 12), brdf), gp);
        nee_d = l_dir;
        nee_max = dist - p.f[kShadowMaxDistEps];
        nee_tp = mul(tp, contrib);
      }
      new_d = cosine_hemisphere(q.nl, u_d1, u_d2, two_pi);
      const float p_diff = 1.0f - p_spec - (1.0f - p_spec) * transmission;
      new_tp = scale(mul(tp, scale(albedo, 1.0f - metallic)),
                     1.0f / p_diff);
      new_prev = false;
    }
  } else if (p.sample[i] + 1 >= p.i[kSppCap]) {
    new_d = cosine_hemisphere(q.nl, u_d1, u_d2, two_pi);
  }

  // Mode transitions; the depth cap still lets NEE fire.
  const long long next_depth = depth + 1;
  const bool alive2 = b_alive && next_depth < p.i[kMaxDepth];
  long long mode = kRefill;
  if (alive2 && !has_shadow) mode = kTraverse;
  if (has_shadow) mode = kShadow;
  p.mode[i] = mode;
  p.cur[i] = 0;
  p.d_min[i] = kMissT;
  p.hit_id[i] = -1;
  store3(p.o, i, new_o);
  store3(p.d, i, new_d);
  store3(p.tp, i, new_tp);
  store3(p.rad, i, rad);
  p.depth[i] = next_depth;
  p.prev_spec[i] = new_prev ? 1 : 0;
  if (has_shadow) {
    store3(p.so, i, o_off);
    store3(p.sd, i, nee_d);
    p.smax[i] = nee_max;
    p.cont_after_shadow[i] = alive2 ? 1 : 0;
  }
  store3(p.pend, i, has_shadow ? nee_tp : v3(0.0f, 0.0f, 0.0f));
  *cont = alive2 ? 1 : 0;
  *fire = has_shadow ? 1 : 0;
  return mode == kRefill;
}

// _refill (owner schedule) for a REFILL lane.  Returns whether the lane
// started a sample (else it retired: DONE).
__device__ __forceinline__ bool refill(const Params& p, long long i) {
  // engine/wavefront.py _sanitize.
  V3 rad = load3(p.rad, i);
  const bool bad = isnan(rad.x) || isnan(rad.y) || isnan(rad.z) ||
                   isinf(rad.x) || isinf(rad.y) || isinf(rad.z);
  if (bad) rad = v3(0.0f, 0.0f, 0.0f);
  rad = v3(clamp_min(rad.x, 0.0f), clamp_min(rad.y, 0.0f),
           clamp_min(rad.z, 0.0f));
  if (p.i[kClampFireflies]) {
    const float lum = rad.x * 0.21f + rad.y * 0.71f + rad.z * 0.07f;
    const float lim = p.f[kFireflyClamp];
    const bool over = lum > lim;
    const float s = over ? lim / lum : 1.0f;
    rad = scale(rad, s);
  }
  store3(p.out, i, add(load3(p.out, i), rad));
  store3(p.rad, i, v3(0.0f, 0.0f, 0.0f));
  const long long next_sample = p.sample[i] + 1;
  const bool exhausted = next_sample >= p.i[kSppCap];
  const unsigned seed =
      static_cast<unsigned>(p.i[kSeedBase]) +
      static_cast<unsigned>(next_sample + p.i[kSampleOffset]);
  p.sample[i] = next_sample;
  p.seed[i] = static_cast<long long>(seed);
  if (exhausted) {
    p.mode[i] = kDone;
    return false;
  }
  V3 r_o, r_d;
  camera_ray(p, p.pix[i], seed, &r_o, &r_d);
  p.mode[i] = kTraverse;
  p.cur[i] = 0;
  p.d_min[i] = kMissT;
  p.hit_id[i] = -1;
  store3(p.o, i, r_o);
  store3(p.d, i, r_d);
  store3(p.tp, i, v3(1.0f, 1.0f, 1.0f));
  p.depth[i] = 0;
  p.prev_spec[i] = 1;
  return true;
}

// One lane's service, in the eager order: a SHADEG lane shades its hit or
// parks in TEXG, a TEXG lane shades with its texture sample, and a lane in
// REFILL, or ended by its shade, flushes its sample and starts the pixel's
// next one or retires.  Other lanes cost one mode read.  Sets *cont and
// *fire (path continued, shadow ray fired) and *started (a camera ray
// started), which stay as they were for a lane not shaded or refilled.
// Returns whether the lane is left not DONE.
__device__ __forceinline__ bool serve(const Params& p, long long i, int* cont,
                                      int* fire, bool* started) {
  const long long mode = p.mode[i];
  bool live = mode != kDone;
  bool to_refill = mode == kRefill;
  if (mode == kShadeG || (mode == kTexG && p.i[kTex0] >= 0)) {
    Surface q;
    bool ready = true;
    if (mode == kShadeG) {
      ready = prepare(p, i, &q);
    } else {
      texture_lane(p, i, &q);
    }
    if (ready) to_refill = finish(p, i, q, cont, fire);
  }
  if (to_refill) {
    *started = refill(p, i);
    live = *started;
  }
  return live;
}

// The pass's parameters from the host arrays the launch receives (floats,
// ints, and the device pointers in PtrParam order), for n lanes and live
// slot `slot`.  Returns false for parameters the kernel does not take.
inline bool unpack_params(const float* floats, const long long* ints,
                          void* const* ptrs, long long n, int slot,
                          Params* out) {
  Params& p = *out;
  for (int k = 0; k < kNumFloats; ++k) p.f[k] = floats[k];
  for (int k = 0; k < kNumInts; ++k) p.i[k] = ints[k];
  if (p.i[kWidth] < 1 || p.i[kHeight] < 1 || p.i[kTableWidth] < kTrimatRow ||
      (p.i[kPack] != 1 && p.i[kPack] != 2) ||
      (p.i[kPack] == 2 && p.i[kTableWidth] < 2 * kTrimatRow) ||
      p.i[kSentinel] < 0 || p.i[kSentinel] > p.i[kTableRows] ||
      (p.i[kTex0] >= 0 && (ptrs[kTstash] == nullptr || p.i[kNumTex] < 1 ||
                           p.i[kTableWidth] < kTexApron * kTexApron * 3)) ||
      p.i[kNumLights] < 0 || n > 0x7fffffffLL * kThreads ||
      (slot != 0 && slot != 1)) {
    return false;
  }
  p.table = static_cast<const float*>(ptrs[kTable]);
  p.lights = static_cast<const float*>(ptrs[kLights]);
  p.metas = static_cast<const long long*>(ptrs[kMetas]);
  p.mode = static_cast<long long*>(ptrs[kMode]);
  p.cur = static_cast<long long*>(ptrs[kCur]);
  p.hit_id = static_cast<long long*>(ptrs[kHitId]);
  p.depth = static_cast<long long*>(ptrs[kDepth]);
  p.sample = static_cast<long long*>(ptrs[kSample]);
  p.seed = static_cast<long long*>(ptrs[kSeed]);
  p.pix = static_cast<const long long*>(ptrs[kPix]);
  p.d_min = static_cast<float*>(ptrs[kDMin]);
  p.o = static_cast<float*>(ptrs[kO]);
  p.d = static_cast<float*>(ptrs[kD]);
  p.tp = static_cast<float*>(ptrs[kTp]);
  p.rad = static_cast<float*>(ptrs[kRad]);
  p.so = static_cast<float*>(ptrs[kSo]);
  p.sd = static_cast<float*>(ptrs[kSd]);
  p.smax = static_cast<float*>(ptrs[kSmax]);
  p.pend = static_cast<float*>(ptrs[kPend]);
  p.out = static_cast<float*>(ptrs[kOut]);
  p.tstash = static_cast<float*>(ptrs[kTstash]);
  p.prev_spec = static_cast<unsigned char*>(ptrs[kPrevSpec]);
  p.cont_after_shadow = static_cast<unsigned char*>(ptrs[kContAfterShadow]);
  p.totals = static_cast<unsigned long long*>(ptrs[kTotals]);
  p.n = n;
  p.slot = slot;
  return true;
}

}  // namespace trt_service

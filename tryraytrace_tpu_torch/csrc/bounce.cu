// The bounce engine's shading, NEE add and camera rays for Hopper
// (sm_90a): three kernels that run between the two threaded walks of a
// bounce (threaded_walk.cu).
//
// What they replace.  On the TPU a bounce-engine sample is one jitted
// lax.while_loop of XLA-fused code, not a Pallas kernel:
// tryraytrace_tpu/engine/wavefront.py:45 render_sample (the camera rays
// and the carry, :61-73, with camera_rays.py:21 generate_rays), :97
// _bounce (the shading) and :232 _nee_contribution (the light sample and
// the NEE add).  Their plain versions are tryraytrace_tpu_torch/ops/
// bounce.py bounce_rays_plain, bounce_shade_plain and bounce_nee_plain,
// the eager blocks the port ran on the card before (~600 launches a
// bounce), and each kernel is held to its plain version bit for bit:
// every product and sum is rounded on its own (built with --fmad=false,
// no fast math, so x / y and 1.0f / x are IEEE), sums of three run left
// to right, sqrt, pow, cos and sin are taken in double and rounded once,
// and every constant is the float32 the tensor code uses (packed on the
// host in ops/service.py's layout).  The arithmetic is
// service_device.cuh's, which the persistent engine's kernels already
// hold to the same eager functions (ops/shade.py surface and scatter):
// camera_ray, barycentric, rough_perturb, reflect, refract_dir,
// cosine_hemisphere, uniform and the vector helpers; the shade below is
// that header's prepare and finish for a lane of the bounce engine,
// which samples its texture from the raw texels (ops/texture.py
// sample_bilinear_wrap, the same taps and sums as the tile rows) and
// keeps its state in the engine's [N, 3] and [N] tensors.
//
//   - bounce_rays_kernel: a sample's camera ray (camera_ray) and its
//     fresh carry: tp 1, rad 0, alive and prev_spec true.
//   - bounce_shade_kernel: for a lane alive at entry, the closest hit's
//     shading: a miss ends the path; the trimat row, the face normal and
//     its two-sided flip, the smooth normal, the planar or interpolated
//     UVs and the lane's own texture (a tex_id outside [0, textures)
//     leaves the albedo as it is), the seven draws, the emission after a
//     specular or refractive bounce, the end of a path at an emitter,
//     the Fresnel branch weights, Russian roulette, the branch the draw
//     picks with its next ray and throughput (the unguarded 1 / p), and
//     on the diffuse branch the light sample (the pick by the float32
//     scale L - 0.001, the dist^2 floor, l_dir from the unclamped
//     vector) that requests a shadow ray where geo_ok holds.  geo_ok is
//     written on every lane it serves, the other NEE fields where it
//     holds.  It lists the lanes alive after the bounce for the next.
//   - bounce_nee_kernel: rad += contrib where geo_ok holds and the
//     any-hit walk found no occluder, over the lanes the bounce's shade
//     served.
//
// What bounds them on this card.  bounce_shade moves a live lane's
// state (o, d, tp, rad, two flags, t, hit_id, pix: ~90 B read, ~60 B
// written, 41 B more for a shadow ray) and reads its 148-byte trimat row
// and four texels from L2 (the table is 3 MB on the main path).  Its
// double sqrt, cos, sin and pow calls (11, 13, 13 and 83 FP64
// instructions each on sm_90a) are the other bound, at the card's FP64
// rate.  bounce_nee and bounce_rays move a few bytes a lane: a launch
// costs about its floor.  On a sparse bounce the live lanes lie scattered
// over the 960,000-lane wave, so a live lane's every field sits in a
// 32-byte sector of its own: the main path's late bounce (79,603 live
// lanes) took 4.7x as long on the wave's lanes as on the same lanes
// gathered into a dense state of their own (PERF.md).  That is the
// state's layout, which this kernel does not change; and a bounce with
// very few lanes costs one lane's dependent chain (list, state, trimat
// row, texture, FP64 calls, the block's atomic), ~0.01 ms.
//
// What the design does about it.
//   - The live lanes are listed.  A block sums its warps' lanes alive
//     after the bounce (a ballot a warp, a prefix in shared memory) and
//     adds them with one 64-bit atomicAdd to the bounce's live count,
//     which starts at 0; the add's old value is the block's offset, and
//     each live lane writes its index (int32) at that offset + its rank
//     among the block's live lanes into the next list (wave_advance.cu's
//     serve_phase lists a warp at a time).  The list's order is the
//     atomics' order, which may change from run to run; it changes
//     nothing a lane computes: each lane reads and writes only its own
//     slots, and the counts are integer sums.  So a step's image is the
//     same bit for bit whatever order its lists came in.  The shadow rays
//     fired are added the same way, one atomic a block: on the fresh
//     state one atomic a warp for each count took 0.0914 ms against
//     0.0744 (same-address atomics queue in L2).
//   - Two launch shapes.  Bounce 0 (no list: bounce_rays left every lane
//     alive), and a bounce whose live lanes are more than
//     TRT_BOUNCE_DENSE_SHARE of the wave, launch over all n lanes, one
//     lane a thread in lane order; below that share a bounce launches
//     ceil(count / 256) blocks over the previous bounce's list, one
//     listed lane a thread, so a sparse bounce costs its live lanes, not
//     the wave.  The host already reads the live count once a bounce to
//     end its loop, so it sizes the grid with no new read.  The NEE add
//     of a bounce runs over the same lanes as its shade: geo_ok can hold
//     only on them.  On the main path a list cost 7% at 98-99% of the
//     lanes alive (one more dependent load a lane) and saved 10% at 70%
//     and more below, so the share is 0.9 (PERF.md).
//   - A lane off the list is neither read nor written.  That is sound by
//     an invariant of the plain version (ops/bounce.py): a lane dead at a
//     bounce's entry leaves it with rad, tp, prev_spec unchanged and
//     alive and geo_ok false, since geo_ok is set only on the diffuse
//     branch, whose lanes stay alive.  So geo_ok is written only on the
//     lanes the shade serves, and a lane that leaves the list keeps the
//     false geo_ok its last shade wrote.
//   - Only the branch a lane takes is computed (as the service kernel
//     does); the state is written in place.  No float atomics.  Launched
//     on the caller's stream; allocates nothing.
//   - Measured and dropped (PERF.md; commit d82af87 builds them with -D
//     flags): the [N, 3] fields of a contiguous tile staged through
//     shared memory and stored in whole 16-byte pieces (lane_init.cu's
//     stores; 72 registers, three blocks an SM: 0.117 ms fresh against
//     0.091 unstaged, 0.103 at 64 registers with spills), and one atomic
//     a warp for the counts.

#include "service_device.cuh"

// A bounce whose lanes alive at entry are more than this share of the
// wave is launched over every lane; at most this share, over its list.
#ifndef TRT_BOUNCE_DENSE_SHARE
#define TRT_BOUNCE_DENSE_SHARE 0.9
#endif

namespace trt_bounce {

using namespace trt_service;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMetaCols = 3;  // texel offset, w, h
constexpr long long kMaxLanes = 0x7fffffffLL;
constexpr double kDenseShare = TRT_BOUNCE_DENSE_SHARE;

// bounce_shade's pointers, in the order of ops/bounce.py SHADE_POINTERS.
enum ShadePtr {
  kPtrTrimat = 0, kPtrTexels, kPtrMetas, kPtrLightRows, kPtrPix, kPtrT,
  kPtrHit, kPtrO, kPtrD, kPtrTp, kPtrRad, kPtrAlive, kPtrPrevSpec,
  kPtrGeoOk, kPtrSo, kPtrSd, kPtrSmax, kPtrContrib, kPtrCounts,
  kNumShadePtrs
};
// The counts a shade adds to (ops/bounce.py COUNTS).
enum Count { kFired = 0, kLiveAfter = 1 };
struct Shade {
  const float* trimat;        // [rows, 37]
  const float* texels;        // every texture, [h, w, 3] one after another
  const long long* metas;     // [textures, 3]: offset in floats, w, h
  const float* lights;        // [lights, 37]
  const long long* pix;
  const float* t;
  const long long* hit;
  float* o;
  float* d;
  float* tp;
  float* rad;
  unsigned char* alive;
  unsigned char* prev_spec;
  unsigned char* geo_ok;      // the NEE fields: null without lights
  float* so;
  float* sd;
  float* smax;
  float* contrib;
  unsigned long long* counts;  // Count
  const int* lanes;           // the lanes to serve; null: lanes [0, count)
  int* next;                  // the lanes alive after; null: not listed
  long long count;
  long long n;
  long long depth;
  unsigned seed;
};

// ops/texture.py sample_bilinear_wrap for texture `tid` at (u, v).
__device__ __forceinline__ V3 texel(const Shade& b, long long tid, float u,
                                    float v) {
  const long long* m = b.metas + kMetaCols * tid;
  const long long w = m[1], h = m[2];
  const float* tex = b.texels + m[0];
  const float x = (u - floorf(u)) * static_cast<float>(w) - 0.5f;
  const float y = (v - floorf(v)) * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  // torch's % of int64 is a floor modulo: -1 % w is w - 1.
  const long long x0i = ((static_cast<long long>(x0) % w) + w) % w;
  const long long y0i = ((static_cast<long long>(y0) % h) + h) % h;
  const long long x1i = (x0i + 1) % w;
  const long long y1i = (y0i + 1) % h;
  const V3 c00 = row3(tex + 3 * (y0i * w + x0i), 0);
  const V3 c10 = row3(tex + 3 * (y0i * w + x1i), 0);
  const V3 c01 = row3(tex + 3 * (y1i * w + x0i), 0);
  const V3 c11 = row3(tex + 3 * (y1i * w + x1i), 0);
  const V3 top = add(scale(c00, 1.0f - fx), scale(c10, fx));
  const V3 bot = add(scale(c01, 1.0f - fx), scale(c11, fx));
  return add(scale(top, 1.0f - fy), scale(bot, fy));
}

// One lane's shade (ops/bounce.py bounce_shade_plain).  Returns whether
// the lane is alive after the bounce; sets *fire where it fired a shadow
// ray.
__device__ __forceinline__ bool shade_lane(const Params& p, const Shade& b,
                                           long long i, int* fire) {
  if (b.geo_ok != nullptr) b.geo_ok[i] = 0;
  if (!b.alive[i]) return false;
  const long long hit = b.hit[i];
  if (hit < 0) {  // a miss ends the path (renderer.cu:427)
    b.alive[i] = 0;
    return false;
  }
  const float two_pi = p.f[kTwoPi];
  const float* row = b.trimat + hit * kTrimatRow;
  const V3 d = load3(b.d, i);
  const V3 x_hit = add(load3(b.o, i), scale(d, b.t[i]));

  // ops/shade.py surface: the face normal and its flip, the UVs and the
  // texture, the smooth normal.
  const V3 v0 = row3(row, 0);
  const V3 v1 = row3(row, 3);
  const V3 v2 = row3(row, 6);
  const V3 nrm_geo = norm(cross(sub(v1, v0), sub(v2, v0)));
  V3 nrm = nrm_geo;
  V3 nl = dot(nrm, d) < 0.0f ? nrm : neg(nrm);
  const V3 nl_off = nl;
  V3 albedo = row3(row, 9);
  const long long n_tex = p.i[kNumTex];
  const bool smooth = p.i[kSmooth] != 0;
  const bool uv_on = n_tex > 0 && p.i[kUv] != 0;
  float b1 = 0.0f, b2 = 0.0f;
  bool okb = false;
  if (smooth || uv_on) barycentric(v0, v1, v2, x_hit, &b1, &b2, &okb);
  if (n_tex > 0) {
    // ops/texture.py planar_uv on the face normal, or interp_uv where
    // the triangle has UVs.
    const bool y_dom = fabsf(nrm_geo.y) > 0.9f;
    const bool x_dom = !y_dom && fabsf(nrm_geo.x) > 0.9f;
    float t_u = y_dom ? x_hit.x : (x_dom ? x_hit.z : x_hit.x);
    float t_v = y_dom ? x_hit.z : x_hit.y;
    t_u = t_u * p.f[kTexPlanarScale];
    t_v = 1.0f - t_v * p.f[kTexPlanarScale];
    if (uv_on && row[36] > 0.0f && okb) {
      const float b0 = 1.0f - b1 - b2;
      t_u = row[30] * b0 + row[32] * b1 + row[34] * b2;
      t_v = 1.0f - (row[31] * b0 + row[33] * b1 + row[35] * b2);
    }
    // tex_id = row[19] as int64, which truncates.
    const long long tid = static_cast<long long>(row[19]);
    if (tid >= 0 && tid < n_tex) albedo = mul(albedo, texel(b, tid, t_u, t_v));
  }
  if (smooth) {
    // ops/shade.py smooth_normal.
    const float b0 = 1.0f - b1 - b2;
    V3 ns = add(add(scale(row3(row, 21), b0), scale(row3(row, 24), b1)),
                scale(row3(row, 27), b2));
    ns = dot(ns, nrm) < 0.0f ? neg(ns) : ns;
    const float len2 = dot(ns, ns);
    if (okb && len2 > 1e-12f) {
      const float len = sqrt64(len2);
      nrm = v3(ns.x / len, ns.y / len, ns.z / len);
    }
    nl = dot(nrm, d) < 0.0f ? nrm : neg(nrm);
  }
  const V3 emission = row3(row, 12);
  const float metallic = row[15], roughness = row[16], ior = row[17];
  const float transmission = row[18];

  // ops/shade.py scatter: the bounce's seven draws (core/rng.py slots).
  const unsigned stream = static_cast<unsigned>(b.pix[i]);
  const unsigned base = kCameraDraws +
                        static_cast<unsigned>(b.depth) * kDrawsPerBounce;
  float u[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) u[k] = uniform(b.seed, stream, base + k);
  V3 tp = load3(b.tp, i);
  V3 rad = load3(b.rad, i);
  const bool prev_spec = b.prev_spec[i] != 0;
  rad = v3(rad.x + (prev_spec ? tp.x * emission.x : 0.0f),
           rad.y + (prev_spec ? tp.y * emission.y : 0.0f),
           rad.z + (prev_spec ? tp.z * emission.z : 0.0f));
  store3(b.rad, i, rad);
  const float thr = p.f[kEmitterStop];
  bool alive = !(emission.x > thr || emission.y > thr || emission.z > thr);

  // Russian roulette (renderer.cu:559-565).
  const float albedo_lum = max3(albedo);
  const bool rr_on = b.depth > p.i[kRrThreshold];
  const float p_live = clamp_min(albedo_lum, p.f[kRrMinP]);
  const bool survive = u[0] < p_live;
  if (rr_on && alive && survive) tp = scale(tp, 1.0f / p_live);
  alive = alive && (!rr_on || survive);
  if (!alive) {  // no branch: tp and prev_spec stay
    b.alive[i] = 0;
    return false;
  }

  // pbr_weights (renderer.cu:509-556).
  const float diffuse_suppression = square64(1.0f - metallic);
  const float spec_attenuation = clamp_min(1.0f - roughness * roughness,
                                           0.0f);
  const float m1 = 1.0f - metallic;
  const V3 f0 = v3(0.04f * m1 + albedo.x * metallic,
                   0.04f * m1 + albedo.y * metallic,
                   0.04f * m1 + albedo.z * metallic);
  const float cos_theta_v = clamp_min(dot(nl, neg(d)), 0.0f);
  const float p5 = pow5_64(1.0f - cos_theta_v);
  const V3 fres = v3(f0.x + (1.0f - f0.x) * p5, f0.y + (1.0f - f0.y) * p5,
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

  // The exclusive branch (renderer.cu:567-571,592,651).
  const float u_b = u[1], u_d1 = u[2], u_d2 = u[3];
  const V3 o_off = add(x_hit, scale(nl_off, p.f[kShadowEps]));
  V3 new_o = o_off, new_d, new_tp;
  bool new_prev, new_alive = true;
  if (u_b < p_spec) {
    // Specular (renderer.cu:571-589).
    new_d = rough_perturb(reflect(d, nrm), roughness, u_d1, u_d2, two_pi);
    new_alive = !(dot(new_d, nl) <= 0.0f);
    new_tp = scale(mul(tp, fres), 1.0f / p_spec);
    new_prev = true;
  } else if (u_b < p_spec + p_trans) {
    // Transmission (renderer.cu:592-648).
    new_d = refract_dir(d, nrm, nl, ior, roughness, u_d1, u_d2, two_pi);
    const float p_branch = (1.0f - p_spec) * transmission;
    const bool pb_ok = p_branch > 1e-4f;
    const float pb = pb_ok ? p_branch : 1.0f;
    const V3 ta = mul(tp, albedo);
    new_tp = pb_ok ? v3(ta.x / pb, ta.y / pb, ta.z / pb) : tp;
    new_o = add(x_hit, scale(new_d, p.f[kRefrOffset]));
    new_prev = true;
  } else {
    // Diffuse + NEE (renderer.cu:651-733).
    const long long lcount = p.i[kNumLights];
    if (lcount > 0) {
      long long pick = 0;
      if (lcount > 1) {
        pick = static_cast<long long>(u[4] * p.f[kLightPickScale]);
        pick = pick < 0 ? 0 : (pick > lcount - 1 ? lcount - 1 : pick);
      }
      const float* lrow = b.lights + pick * kTrimatRow;
      const V3 lv0 = row3(lrow, 0);
      const V3 lv1 = row3(lrow, 3);
      const V3 lv2 = row3(lrow, 6);
      // sample_triangle.
      const float sqr1 = sqrt64(u[5]);
      const float a = 1.0f - sqr1;
      const float bb = sqr1 * (1.0f - u[6]);
      const float c = 1.0f - a - bb;
      const V3 light_pos = add(add(scale(lv0, a), scale(lv1, bb)),
                               scale(lv2, c));
      const V3 to_light = sub(light_pos, x_hit);
      float dist_sq = dot(to_light, to_light);
      if (p.i[kNeeFloorOn]) {
        dist_sq = clamp_min(dist_sq, p.f[kNeeDistSqFloor]);
      }
      const float dist = sqrt64(dist_sq);
      const V3 l_dir = scale(to_light, 1.0f / dist);
      const float cos_theta = dot(nl, l_dir);
      const V3 light_n = norm(cross(sub(lv1, lv0), sub(lv2, lv0)));
      const float cos_light = -dot(light_n, l_dir);
      if (cos_theta > 0.0f && cos_light > 0.0f) {
        const float area = lrow[20];
        const float pdf = 1.0f / (area * p.f[kLightCountF]);
        const float g_term = (cos_theta * cos_light) / dist_sq;
        const float gp = g_term / pdf;
        const V3 brdf = scale(albedo, p.f[kInvPi]);
        const V3 contrib = scale(mul(row3(lrow, 12), brdf), gp);
        b.geo_ok[i] = 1;
        store3(b.so, i, o_off);
        store3(b.sd, i, l_dir);
        b.smax[i] = dist - p.f[kShadowMaxDistEps];
        store3(b.contrib, i, mul(tp, contrib));
        *fire = 1;
      }
    }
    new_d = cosine_hemisphere(nl, u_d1, u_d2, two_pi);
    const float p_diff = 1.0f - p_spec - (1.0f - p_spec) * transmission;
    new_tp = scale(mul(tp, scale(albedo, 1.0f - metallic)), 1.0f / p_diff);
    new_prev = false;
  }
  store3(b.o, i, new_o);
  store3(b.d, i, new_d);
  store3(b.tp, i, new_tp);
  b.prev_spec[i] = new_prev ? 1 : 0;
  b.alive[i] = new_alive ? 1 : 0;
  return new_alive;
}

// The counts and the next list.  A block adds its warps' lanes alive
// after the bounce with one atomicAdd to the live count (whose old value
// is the block's offset) and its shadow rays with one more; lane i (any
// value where !live) alive after takes the slot of its rank among the
// block's live lanes, warp by warp.  Called by every thread of the block.
__device__ __forceinline__ void count_and_list(const Shade& b, long long i,
                                               bool live, int fire) {
  __shared__ unsigned long long warp_at[kWarps];
  __shared__ int warp_fire[kWarps];
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int w = static_cast<int>(threadIdx.x >> 5);
  const unsigned keep = __ballot_sync(kFull, live);
  fire = __reduce_add_sync(kFull, fire);
  if (lane == 0) {
    warp_at[w] = __popc(keep);
    warp_fire[w] = fire;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    int fired = 0;
    for (int k = 0; k < kWarps; ++k) {
      const unsigned long long c = warp_at[k];
      warp_at[k] = total;
      total += c;
      fired += warp_fire[k];
    }
    const unsigned long long base =
        total ? atomicAdd(b.counts + kLiveAfter, total) : 0ull;
    for (int k = 0; k < kWarps; ++k) warp_at[k] += base;
    if (fired) {
      atomicAdd(b.counts + kFired, static_cast<unsigned long long>(fired));
    }
  }
  __syncthreads();
  const unsigned long long slot =
      warp_at[w] +
      static_cast<unsigned long long>(__popc(keep & ((1u << lane) - 1u)));
  // A slot past n only if the live count did not start at 0: unlisted.
  if (live && b.next != nullptr &&
      slot < static_cast<unsigned long long>(b.n)) {
    b.next[slot] = static_cast<int>(i);
  }
}

// The shade of one lane a thread: lane j of the list, or lane j.
__global__ void __launch_bounds__(kBlock)
    bounce_shade_kernel(const Params p, const Shade b) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  long long i = -1;
  bool live = false;
  int fire = 0;
  if (j < b.count) {
    i = b.lanes != nullptr ? b.lanes[j] : j;
    live = shade_lane(p, b, i, &fire);
  }
  count_and_list(b, i, live, fire);
}

__global__ void __launch_bounds__(kBlock)
    bounce_rays_kernel(const Params p, const long long* pix, long long n,
                       unsigned seed, float* o, float* d, float* tp,
                       float* rad, unsigned char* alive,
                       unsigned char* prev_spec) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  V3 r_o, r_d;
  camera_ray(p, pix[i], seed, &r_o, &r_d);
  store3(o, i, r_o);
  store3(d, i, r_d);
  store3(tp, i, v3(1.0f, 1.0f, 1.0f));
  store3(rad, i, v3(0.0f, 0.0f, 0.0f));
  alive[i] = 1;
  prev_spec[i] = 1;
}

__global__ void __launch_bounds__(kBlock)
    bounce_nee_kernel(long long count, const int* lanes,
                      const unsigned char* geo_ok,
                      const unsigned char* occluded, const float* contrib,
                      float* rad) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (j >= count) return;
  const long long i = lanes != nullptr ? lanes[j] : j;
  if (!geo_ok[i] || occluded[i]) return;
  store3(rad, i, add(load3(rad, i), load3(contrib, i)));
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

bool unpack(const float* floats, const long long* ints, Params* p) {
  *p = Params{};
  for (int k = 0; k < kNumFloats; ++k) p->f[k] = floats[k];
  for (int k = 0; k < kNumInts; ++k) p->i[k] = ints[k];
  return p->i[kNumTex] >= 0 && p->i[kNumLights] >= 0;
}

unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

// Whether a launch over the list `lanes` of `count` of n lanes takes the
// list (else it runs over all n lanes): the shade and its NEE add decide
// alike.
bool listed(const int* lanes, long long count, long long n) {
  return lanes != nullptr &&
         !(static_cast<double>(count) > kDenseShare * static_cast<double>(n));
}

// The arguments of a launch over `lanes` (null: all n) of `count` lanes.
bool lanes_ok(const int* lanes, long long count, long long n) {
  return n <= kMaxLanes && (lanes == nullptr ? count == n
                                             : aligned16(lanes) &&
                                                   count >= 0 && count <= n);
}

}  // namespace trt_bounce

// The sizes of the arrays the launches read, for the caller to check
// against its own (floats, ints, bounce_shade's pointers), then the
// build's dense share (TRT_BOUNCE_DENSE_SHARE) in thousandths.
extern "C" int trt_bounce_layout(int* out) {
  out[0] = trt_service::kNumFloats;
  out[1] = trt_service::kNumInts;
  out[2] = trt_bounce::kNumShadePtrs;
  out[3] = static_cast<int>(trt_bounce::kDenseShare * 1000.0 + 0.5);
  return 0;
}

// A sample's camera rays and fresh carry for the n pixels `pix` with
// sample seed `seed` (the low 32 bits), on `stream`.  floats / ints are
// ops/service.py's layout (the camera, the raster).  Every pointer is
// 16-byte aligned.  Returns the CUDA error of the launch (0 = launched),
// 1 (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int trt_bounce_rays_launch(const float* floats,
                                      const long long* ints,
                                      const long long* pix, long long n,
                                      long long seed, float* o, float* d,
                                      float* tp, float* rad,
                                      unsigned char* alive,
                                      unsigned char* prev_spec,
                                      void* stream) {
  using namespace trt_bounce;
  if (n <= 0) return 0;
  Params p;
  const void* ptrs[] = {pix, o, d, tp, rad, alive, prev_spec};
  bool ok = unpack(floats, ints, &p) && n <= kMaxLanes &&
            p.i[kWidth] >= 1 && p.i[kHeight] >= 1;
  for (const void* ptr : ptrs) ok = ok && ptr != nullptr && aligned16(ptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  bounce_rays_kernel<<<blocks(n), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, pix, n, static_cast<unsigned>(seed), o, d, tp, rad, alive,
      prev_spec);
  return static_cast<int>(cudaGetLastError());
}

// One bounce's shade at bounce `depth` with sample seed `seed` on
// `stream`, of the `count` lanes listed in `lanes` (int32, each in
// [0, n)), or of all n lanes where `lanes` is null (count = n).  floats /
// ints are ops/service.py's layout; ptrs a host array of the device
// pointers in ShadePtr order (texels and metas null without textures, the
// lights and the NEE fields null without lights), each 16-byte aligned.
// Writes the served lanes' state in place, adds the shadow rays fired and
// the lanes alive after to counts, and, where `next` is not null (int32
// [n], not `lanes`), lists the lanes alive after in next[0, live) if the
// live count started at 0.  Returns the CUDA error of the launch (0 =
// launched), 1 (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int trt_bounce_shade_launch(const float* floats,
                                       const long long* ints,
                                       void* const* ptrs, long long n,
                                       const int* lanes, long long count,
                                       int* next, long long seed,
                                       long long depth, void* stream) {
  using namespace trt_bounce;
  if (n <= 0 || count == 0) return 0;
  Params p;
  bool ok = unpack(floats, ints, &p) && lanes_ok(lanes, count, n) &&
            depth >= 0 && (next == nullptr || (aligned16(next) &&
                                               next != lanes));
  const bool textured = p.i[kNumTex] > 0;
  const bool lights = p.i[kNumLights] > 0;
  for (int k = 0; ok && k < kNumShadePtrs; ++k) {
    const bool nee =
        k == kPtrLightRows || (k >= kPtrGeoOk && k <= kPtrContrib);
    const bool needed = (k == kPtrTexels || k == kPtrMetas) ? textured
                        : nee                               ? lights
                                                            : true;
    ok = (ptrs[k] == nullptr ? !needed : aligned16(ptrs[k]));
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Shade b;
  b.trimat = static_cast<const float*>(ptrs[kPtrTrimat]);
  b.texels = static_cast<const float*>(ptrs[kPtrTexels]);
  b.metas = static_cast<const long long*>(ptrs[kPtrMetas]);
  b.lights = static_cast<const float*>(ptrs[kPtrLightRows]);
  b.pix = static_cast<const long long*>(ptrs[kPtrPix]);
  b.t = static_cast<const float*>(ptrs[kPtrT]);
  b.hit = static_cast<const long long*>(ptrs[kPtrHit]);
  b.o = static_cast<float*>(ptrs[kPtrO]);
  b.d = static_cast<float*>(ptrs[kPtrD]);
  b.tp = static_cast<float*>(ptrs[kPtrTp]);
  b.rad = static_cast<float*>(ptrs[kPtrRad]);
  b.alive = static_cast<unsigned char*>(ptrs[kPtrAlive]);
  b.prev_spec = static_cast<unsigned char*>(ptrs[kPtrPrevSpec]);
  b.geo_ok = lights ? static_cast<unsigned char*>(ptrs[kPtrGeoOk]) : nullptr;
  b.so = static_cast<float*>(ptrs[kPtrSo]);
  b.sd = static_cast<float*>(ptrs[kPtrSd]);
  b.smax = static_cast<float*>(ptrs[kPtrSmax]);
  b.contrib = static_cast<float*>(ptrs[kPtrContrib]);
  b.counts = static_cast<unsigned long long*>(ptrs[kPtrCounts]);
  b.next = next;
  b.n = n;
  b.depth = depth;
  b.seed = static_cast<unsigned>(seed);
  const bool list = listed(lanes, count, n);
  b.lanes = list ? lanes : nullptr;
  b.count = list ? count : n;
  bounce_shade_kernel<<<blocks(b.count), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(p, b);
  return static_cast<int>(cudaGetLastError());
}

// The NEE add on `stream` of the `count` lanes listed in `lanes` (null:
// all n lanes, count = n), the lanes the bounce's shade served: rad +=
// contrib where geo_ok holds and occluded does not.  Every pointer is
// 16-byte aligned.  Returns the CUDA error of the launch (0 = launched),
// 1 (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int trt_bounce_nee_launch(long long n, const int* lanes,
                                     long long count,
                                     const unsigned char* geo_ok,
                                     const unsigned char* occluded,
                                     const float* contrib, float* rad,
                                     void* stream) {
  using namespace trt_bounce;
  if (n <= 0 || count == 0) return 0;
  const void* ptrs[] = {geo_ok, occluded, contrib, rad};
  bool ok = lanes_ok(lanes, count, n);
  for (const void* ptr : ptrs) ok = ok && ptr != nullptr && aligned16(ptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool list = listed(lanes, count, n);
  const long long m = list ? count : n;
  bounce_nee_kernel<<<blocks(m), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      m, list ? lanes : nullptr, geo_ok, occluded, contrib, rad);
  return static_cast<int>(cudaGetLastError());
}

// The quad-row walk's device code, shared by the walk kernel
// (quad_walk.cu: every walking lane's walk to its end, one launch a
// round) and the wave kernel (wave_advance.cu: each lane's walks and
// services to its budget, one launch a Wave.advance).  quad_walk.cu's
// notes say what it computes, what bounds it on this card and what its
// design does about that.  Here: the lane modes and row layout, the
// ray/triangle and slab tests, the skip-register file, the walk of one
// lane (Walk: start, step, finish), the staging of the top tree levels
// in shared memory and the launch plan that sizes it.
//
// Every product and sum is rounded on its own (built with --fmad=false,
// no fast math), sums of three run left to right, and min and max give
// NaN when an operand is NaN, as the plain PyTorch walk's do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Loads of the lane state that the walk reads and never writes (o, d, so,
// sd, smax, pend).  The walk kernel reads it through the read-only data
// cache.  A kernel that also writes that state (the wave kernel, whose
// service pass writes it between walks) defines this as a plain load
// before it includes this header: a read-only-cache load of data that
// the same kernel writes is undefined.
#ifndef TRT_WALK_STATE_LOAD
#define TRT_WALK_STATE_LOAD(ptr) __ldg(ptr)
#endif

namespace trt {

// Lane modes (ops/walk.py).
constexpr long long kTraverse = 0;
constexpr long long kShadow = 1;
constexpr long long kRefill = 3;
constexpr long long kShadeG = 5;

// Quad-row layout (accel/bvh.py pack_quad_table, "mux" layout).
constexpr int kColCont = 2;     // 8 per-octant (continuation << 8 | perm)
constexpr int kColBody = 10;    // 4 child boxes, or K leaf slots
constexpr int kBodyEnt = 24;    // 4 child entry rows
constexpr int kBodyNslots = 28; // number of valid children
// Leaf slot formats (ops/walk.py LEAF_FORMATS).
constexpr int kFmtBW = 0;       // Baldwin-Weber (n, v0, bu, bv)
constexpr int kFmtMT = 1;       // Moller-Trumbore (v0, e1, e2)
// Floats per leaf slot of format F.
template <int F>
constexpr int kLeafStride = F == kFmtMT ? 9 : 12;
// Floats 0-39 as ten 16-byte chunks: an internal row (floats 0-38) whole,
// a leaf row's header and the slots that end by float 39 (two
// Baldwin-Weber, three Moller-Trumbore).
constexpr int kHeadChunks = 10;
template <int F>
constexpr int kHeadSlots = (4 * kHeadChunks - kColBody) / kLeafStride<F>;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// A warp claims new lanes once this many of its threads are idle, or all
// are: the fastest of 1, 8, 16 and 32 on an H100 (PERF.md).  The most
// tree levels the plan stages.  A benchmark build may set either
// (scripts/microbench_torch_walk.py); the port builds the defaults.
#ifndef TRT_WALK_REFILL_IDLE
#define TRT_WALK_REFILL_IDLE 16
#endif
#ifndef TRT_WALK_MAX_LEVELS
#define TRT_WALK_MAX_LEVELS 64
#endif
constexpr int kRefillIdle = TRT_WALK_REFILL_IDLE;
constexpr int kMaxLevels = TRT_WALK_MAX_LEVELS;
static_assert(kRefillIdle >= 1 && kRefillIdle <= 32, "refill threshold");

constexpr float kMissT = 1e20f;
constexpr float kEps = 1e-5f;
constexpr float kShadowTMin = 1e-3f;

// The staged top rows, `stride4` 16-byte units apart.
extern __shared__ float4 staged_rows[];

// min and max that give NaN when either operand is NaN, as
// torch.minimum / maximum / amax / amin do.  The shadow walk's plain 1/d
// makes 0 * inf = NaN in the slab test, and the comparisons must then say
// "miss"; fminf / fmaxf would drop the NaN and could say "hit".  On the
// card this is one instruction (min.NaN / max.NaN, sm_80 and later); the
// slab tests take 40 of them per internal row.
__device__ __forceinline__ float nan_min(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
#endif
}
__device__ __forceinline__ float nan_max(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
#endif
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  float t_min;
  int octant;
};

// The walk's ray of lane `i` from o, d [n, 3].  The closest-hit walk uses
// the sign-preserving safe inverse (|d| < 1e-8 -> +-1e20), the shadow walk
// a plain reciprocal.
__device__ __forceinline__ Ray make_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        long long i, bool shadow) {
  Ray r;
  r.octant = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = TRT_WALK_STATE_LOAD(o + 3 * i + a);
    r.d[a] = TRT_WALK_STATE_LOAD(d + 3 * i + a);
    const bool tiny = fabsf(r.d[a]) < 1e-8f && !shadow;
    const float q = 1.0f / (tiny ? 1.0f : r.d[a]);
    r.inv[a] = tiny ? (r.d[a] >= 0.0f ? 1e20f : -1e20f) : q;
    if (r.d[a] < 0.0f) r.octant |= 1 << a;
  }
  r.t_min = shadow ? kShadowTMin : 0.0f;
  return r;
}

// Where a row is read: the first `staged` rows from shared memory, the
// others from the table in device memory (width4 units a row).  The row's
// address is chosen once; its loads are generic loads, which the card
// sends to shared memory or L1/L2 by the address.
struct Rows {
  const float4* __restrict__ table;
  int width4;
  int stride4;
  int staged;

  __device__ __forceinline__ const float4* row(int r) const {
    return r < staged ? staged_rows + r * stride4
                      : table + static_cast<size_t>(r) * width4;
  }
};

// Baldwin-Weber ray/triangle test on one 12-float slot (n, v0, bu, bv):
// t, or 0 for a miss.  An all-zero pad slot misses by the parallel guard.
__device__ __forceinline__ float baldwin_t(const float s[12], const Ray& r) {
  const float nd = (s[0] * r.d[0] + s[1] * r.d[1]) + s[2] * r.d[2];
  const bool parallel = fabsf(nd) < kEps;
  const float f = 1.0f / (parallel ? 1.0f : nd);
  const float s0 = r.o[0] - s[3];
  const float s1 = r.o[1] - s[4];
  const float s2 = r.o[2] - s[5];
  const float t = (-f) * ((s[0] * s0 + s[1] * s1) + s[2] * s2);
  const float p0 = s0 + t * r.d[0];
  const float p1 = s1 + t * r.d[1];
  const float p2 = s2 + t * r.d[2];
  const float u = (s[6] * p0 + s[7] * p1) + s[8] * p2;
  const float v = (s[9] * p0 + s[10] * p1) + s[11] * p2;
  const bool valid =
      !parallel && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kEps;
  return valid ? t : 0.0f;
}

// Moller-Trumbore ray/triangle test on one 9-float slot (v0, e1, e2): t,
// or 0 for a miss (ops/intersect.py moller_trumbore_pre).  An all-zero
// pad slot gives a = 0, which the parallel guard rejects.
__device__ __forceinline__ float moller_trumbore_t(const float s[9],
                                                   const Ray& r) {
  const float h0 = r.d[1] * s[8] - r.d[2] * s[7];
  const float h1 = r.d[2] * s[6] - r.d[0] * s[8];
  const float h2 = r.d[0] * s[7] - r.d[1] * s[6];
  const float a = (s[3] * h0 + s[4] * h1) + s[5] * h2;
  const bool parallel = fabsf(a) < kEps;
  const float f = 1.0f / (parallel ? 1.0f : a);
  const float s0 = r.o[0] - s[0];
  const float s1 = r.o[1] - s[1];
  const float s2 = r.o[2] - s[2];
  const float u = f * ((s0 * h0 + s1 * h1) + s2 * h2);
  const float q0 = s1 * s[5] - s2 * s[4];
  const float q1 = s2 * s[3] - s0 * s[5];
  const float q2 = s0 * s[4] - s1 * s[3];
  const float v = f * ((r.d[0] * q0 + r.d[1] * q1) + r.d[2] * q2);
  const float t = f * ((s[6] * q0 + s[7] * q1) + s[8] * q2);
  const bool valid = !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                     u + v <= 1.0f && t > kEps;
  return valid ? t : 0.0f;
}

template <int F>
__device__ __forceinline__ float slot_t(const float (&s)[kLeafStride<F>],
                                        const Ray& r) {
  if constexpr (F == kFmtMT) {
    return moller_trumbore_t(s, r);
  } else {
    return baldwin_t(s, r);
  }
}

// Closest hit among a leaf row's k slots of format F inside the open
// window (tlo, thi): the lowest slot wins a tie in t (strict <).  The
// slots that end by float 39 come from the row's first chunks, the others
// are loaded here: a Baldwin-Weber slot 16 bytes at a time where it is
// aligned (it starts 8 bytes into a 16-byte unit), a Moller-Trumbore slot
// (which starts anywhere in a unit) one float at a time.  Returns the
// slot, or -1 when none hits; best_t is then kMissT.
template <int F>
__device__ __forceinline__ int leaf_test(const float4 (&c)[kHeadChunks],
                                         const float4* row, int k,
                                         const Ray& r, float tlo, float thi,
                                         float& best_t) {
  constexpr int kStride = kLeafStride<F>;
  best_t = kMissT;
  int best = -1;
#pragma unroll
  for (int j = 0; j < kHeadSlots<F>; ++j) {
    if (j < k) {
      float s[kStride];
#pragma unroll
      for (int i = 0; i < kStride; ++i) {
        const int f = kColBody + kStride * j + i;
        s[i] = part(c[f >> 2], f & 3);
      }
      const float t = slot_t<F>(s, r);
      const float cand = (t > tlo && t < thi) ? t : kMissT;
      if (cand < best_t) {
        best_t = cand;
        best = j;
      }
    }
  }
  for (int j = kHeadSlots<F>; j < k; ++j) {
    const int b = kColBody + kStride * j;
    float s[kStride];
    if constexpr (F == kFmtMT) {
      const float* rowf = reinterpret_cast<const float*>(row);
#pragma unroll
      for (int i = 0; i < kStride; ++i) s[i] = rowf[b + i];
    } else {
      // b is even: 16 B unit + 8 B.
      const float2* row2 = reinterpret_cast<const float2*>(row);
      const float2 a = row2[b >> 1];
      const float4 p = row[(b + 2) >> 2];
      const float4 q = row[(b + 6) >> 2];
      const float2 z = row2[(b + 10) >> 1];
      const float bw[12] = {a.x, a.y, p.x, p.y, p.z, p.w,
                            q.x, q.y, q.z, q.w, z.x, z.y};
#pragma unroll
      for (int i = 0; i < kStride; ++i) s[i] = bw[i];
    }
    const float t = slot_t<F>(s, r);
    const float cand = (t > tlo && t < thi) ? t : kMissT;
    if (cand < best_t) {
      best_t = cand;
      best = j;
    }
  }
  return best;
}

// Slab test of child box c (min xyz, max xyz) of an internal row against
// (t_min, t_max).
__device__ __forceinline__ bool box_hit(const float4 (&ch)[kHeadChunks],
                                        int c, const Ray& r, float t_max) {
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int f0 = kColBody + 6 * c + i;
    const int f1 = f0 + 3;
    const float t1 = (part(ch[f0 >> 2], f0 & 3) - r.o[i]) * r.inv[i];
    const float t2 = (part(ch[f1 >> 2], f1 & 3) - r.o[i]) * r.inv[i];
    const float near_i = nan_min(t1, t2);
    const float far_i = nan_max(t1, t2);
    lo = i == 0 ? near_i : nan_max(lo, near_i);
    hi = i == 0 ? far_i : nan_min(hi, far_i);
  }
  return hi >= lo && hi > r.t_min && lo < t_max;
}

__device__ __forceinline__ int select4(const int v[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// What an internal row tells the walk: the first hit child's entry row
// (the continuation if none hit) and, for positions 1..3 of the octant's
// front-to-back order, whether that sibling is valid, was missed and lies
// behind a hit child (push), with its entry row and its thread successor.
struct Decode {
  int next;
  bool push[3];
  int target[3];
  int succ[3];
};

__device__ __forceinline__ Decode quad_decode(
    const float4 (&ch)[kHeadChunks], const Ray& r, int cont, int perm,
    float t_max) {
  int hits = 0;
  int ents[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (box_hit(ch, c, r, t_max)) hits |= 1 << c;
    const int f = kColBody + kBodyEnt + c;
    ents[c] = static_cast<int>(part(ch[f >> 2], f & 3));
  }
  const int fn = kColBody + kBodyNslots;
  const int nsl = static_cast<int>(
      fminf(fmaxf(part(ch[fn >> 2], fn & 3), 0.0f), 4.0f));
  bool hit_p[4];
  int ent_p[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int slot = (perm >> (2 * p)) & 3;
    hit_p[p] = ((hits >> slot) & 1) && p < nsl;
    ent_p[p] = select4(ents, slot);
  }
  Decode dec;
  dec.next = hit_p[0]   ? ent_p[0]
             : hit_p[1] ? ent_p[1]
             : hit_p[2] ? ent_p[2]
             : hit_p[3] ? ent_p[3]
                        : cont;
  bool before = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    before = before || hit_p[i];
    dec.push[i] = before && !hit_p[i + 1] && i + 1 < nsl;
    dec.target[i] = ent_p[i + 1];
    dec.succ[i] = (i + 2 < nsl && i < 2) ? ent_p[(i + 2) & 3] : cont;
  }
  return dec;
}

// The skip-register file: R (entry row -> thread successor) pairs, newest
// first.  An entry of -1 is empty.
template <int R>
struct RegFile {
  int entry[R > 0 ? R : 1];
  int succ[R > 0 ? R : 1];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      entry[i] = -1;
      succ[i] = -1;
    }
  }

  // Shift-push the row's missed siblings, farthest first.
  __device__ __forceinline__ void push(const Decode& dec) {
#pragma unroll
    for (int i = 2; i >= 0; --i) {
      if (!dec.push[i]) continue;
#pragma unroll
      for (int j = R - 1; j > 0; --j) {
        entry[j] = entry[j - 1];
        succ[j] = succ[j - 1];
      }
      if (R > 0) {
        entry[0] = dec.target[i];
        succ[0] = dec.succ[i];
      }
    }
  }

  // Redirect `next` past known-missed entries, consuming each match.
  __device__ __forceinline__ int redirect(int next, int passes) {
    for (int pass = 0; pass < passes; ++pass) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (entry[i] >= 0 && next == entry[i]) {
          next = succ[i];
          entry[i] = -1;
        }
      }
    }
    return next;
  }
};

struct Params {
  const float4* table;  // walk-order quad rows, width4 16-byte units a row
  int width4;
  int stride4;          // staged rows' spacing in shared memory
  int staged;           // rows staged in shared memory
  int sentinel;
  int k;
  int passes;
  long long n;
  long long* mode_io;
  long long* cur_io;
  long long* hit_id_io;
  float* d_min_io;
  float* rad_io;
  const float* o;
  const float* d;
  const float* so;
  const float* sd;
  const float* smax;
  const float* pend;
  const unsigned char* cont_after_shadow;
  unsigned long long* next_lane;  // counters[0]: lanes claimed
  unsigned long long* rows_out;   // counters[1]: rows fetched
};

// A thread's current walk: R skip registers, leaf slots of format F.
template <int R, int F>
struct Walk {
  long long lane;  // -1: the thread is idle
  bool shadow;
  Ray r;
  float smax;
  float d_min;
  int cur;
  long long hit_id;
  RegFile<R> regs;

  // Take lane i if it walks.  Costs one mode read when it does not.
  __device__ __forceinline__ void start(const Params& p, long long i) {
    const long long mode = p.mode_io[i];
    if (mode != kTraverse && mode != kShadow) return;
    lane = i;
    shadow = mode == kShadow;
    const long long cur64 = p.cur_io[i];
    cur = cur64 < p.sentinel ? static_cast<int>(cur64) : p.sentinel;
    d_min = p.d_min_io[i];
    hit_id = p.hit_id_io[i];
    r = shadow ? make_ray(p.so, p.sd, i, true) : make_ray(p.o, p.d, i, false);
    smax = shadow ? TRT_WALK_STATE_LOAD(p.smax + i) : 0.0f;
    regs.clear();
  }

  __device__ __forceinline__ void finish(const Params& p, long long mode) {
    p.mode_io[lane] = mode;
    p.cur_io[lane] = cur;
    p.d_min_io[lane] = d_min;
    p.hit_id_io[lane] = hit_id;
    lane = -1;
  }

  // Fetch row `cur` and take one step of the walk; ends the walk (writes
  // the lane back and goes idle) when it is over.
  __device__ __forceinline__ void step(const Params& p, const Rows& rows) {
    if (cur == 0) regs.clear();
    const float4* row =
        rows.row(cur < p.sentinel - 1 ? cur : p.sentinel - 1);
    float4 c[kHeadChunks];
#pragma unroll
    for (int i = 0; i < kHeadChunks; ++i) c[i] = row[i];
    const int prim_start = static_cast<int>(c[0].x);
    float cpf = part(c[kColCont >> 2], kColCont & 3);
#pragma unroll
    for (int oct = 1; oct < 8; ++oct) {
      const int f = kColCont + oct;
      if (r.octant == oct) cpf = part(c[f >> 2], f & 3);
    }
    const int cpi = static_cast<int>(cpf);
    const int cont = cpi >> 8;
    int next = cont;
    bool occluded = false;
    if (prim_start >= 0) {
      float best_t;
      const float thi = shadow ? smax - kShadowTMin : d_min;
      const int slot = leaf_test<F>(c, row, p.k, r, r.t_min, thi, best_t);
      if (slot >= 0 && best_t < kMissT) {
        if (shadow) {
          occluded = true;
        } else {
          d_min = best_t;
          hit_id = static_cast<long long>(prim_start) + slot;
        }
      }
    } else {
      const Decode dec =
          quad_decode(c, r, cont, cpi & 255, shadow ? smax : d_min);
      next = dec.next;
      regs.push(dec);
    }
    cur = regs.redirect(next, p.passes);
    if (shadow) {
      if (!occluded && cur < p.sentinel) return;
      // The plain step adds where(lit, pend, 0.0): a finished shadow
      // lane's rad gets + 0.0 when occluded.
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float* rad = p.rad_io + 3 * lane + a;
        *rad = *rad + (occluded ? 0.0f
                             : TRT_WALK_STATE_LOAD(p.pend + 3 * lane + a));
      }
      cur = 0;
      d_min = kMissT;
      hit_id = -1;
      if (p.cont_after_shadow[lane]) {
        // The path's next bounce: walk on for its closest hit.
        shadow = false;
        r = make_ray(p.o, p.d, lane, false);
      } else {
        finish(p, kRefill);
      }
    } else if (cur >= p.sentinel) {
      finish(p, hit_id >= 0 ? kShadeG : kRefill);
    }
  }
};

// The walks of `count` lanes to their ends: lane list[i] for i < count,
// or lane i without a list.  The threads of a block take lanes from the
// counter *next_lane (zero at the start, shared by every block) until
// none is left.  When kRefillIdle or more threads of a warp are idle (or
// all are), the warp claims that many lanes with one atomicAdd (ballot +
// popc) and each idle thread takes one; a lane that does not walk costs
// its thread one mode read.  Called by every thread of the block; every
// thread of a warp runs its claims together.  Returns the rows this
// thread fetched.
template <int R, int F>
__device__ __forceinline__ unsigned long long walk_lanes(
    const Params& p, const Rows& rows, unsigned long long* next_lane,
    const int* list, long long count) {
  const int lane_in_warp = threadIdx.x & 31;
  const unsigned below = (1u << lane_in_warp) - 1u;
  unsigned long long fetched = 0;
  bool exhausted = false;  // the same in every thread of the warp
  Walk<R, F> w;
  w.lane = -1;
  for (;;) {
    unsigned busy = __ballot_sync(kFull, w.lane >= 0);
    while (!exhausted &&
           (busy == 0 || 32 - __popc(busy) >= kRefillIdle)) {
      const unsigned idle = ~busy;
      const unsigned want = static_cast<unsigned>(__popc(idle));
      unsigned long long base = 0;
      if (lane_in_warp == 0) {
        base = atomicAdd(next_lane, static_cast<unsigned long long>(want));
      }
      base = __shfl_sync(kFull, base, 0);
      exhausted = base + want >= static_cast<unsigned long long>(count);
      if (w.lane < 0) {
        const unsigned long long i = base + __popc(idle & below);
        if (i < static_cast<unsigned long long>(count)) {
          w.start(p, list ? list[i] : static_cast<long long>(i));
        }
      }
      busy = __ballot_sync(kFull, w.lane >= 0);
    }
    if (busy == 0) break;
    if (w.lane >= 0) {
      ++fetched;
      w.step(p, rows);
    }
  }
  return fetched;
}

// Each block copies the first p.staged rows of the table into shared
// memory, p.stride4 16-byte units apart, and waits for the copy.  Called
// by every thread of the block at the kernel's start.
__device__ __forceinline__ void stage_rows(const Params& p) {
  const int n4 = p.staged * p.width4;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const int row = i / p.width4;
    staged_rows[row * p.stride4 + (i - row * p.width4)] = __ldg(p.table + i);
  }
  __syncthreads();
}

// Shared memory per block for `staged` rows.
inline size_t staged_bytes(int staged, int stride4) {
  return static_cast<size_t>(staged) * stride4 * sizeof(float4);
}

// Rows an odd number of 16-byte units apart, so rows in a quarter-warp's
// load spread over the banks.
inline int staged_stride4(int width) { return (width / 4) | 1; }

// The launch plan of `kernel` (kThreads threads a block, the top rows in
// dynamic shared memory): stage whole levels, as many as fit beside the
// blocks that the kernel's registers let an SM hold (less its static
// shared memory), and launch as many blocks as the card then holds at
// once.  plan[0..5): rows staged, shared bytes, grid, blocks per SM,
// threads per block.  Returns a CUDA error (0 = planned).
template <typename Kernel>
int plan_staged(Kernel kernel, int sentinel, int stride4,
                const long long* levels, int n_levels, int* plan) {
  int dev = 0, sms = 0, per_sm = 0, per_block = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(
        &per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  int by_regs = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&by_regs, kernel,
                                                      kThreads, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (by_regs < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long budget = per_sm / by_regs - reserved;
  if (budget > per_block) budget = per_block;
  budget -= static_cast<long long>(attr.sharedSizeBytes);
  long long staged = 0;
  for (int l = 0; l < n_levels && l < kMaxLevels; ++l) {
    const long long more = staged + levels[l];
    if (more > sentinel ||
        static_cast<long long>(staged_bytes(static_cast<int>(more),
                                            stride4)) > budget) {
      break;
    }
    staged = more;
  }
  const size_t smem = staged_bytes(static_cast<int>(staged), stride4);
  // Raise the kernel's dynamic shared memory limit, never lower it: a
  // plan made earlier for another table stays valid.
  if (static_cast<size_t>(attr.maxDynamicSharedSizeBytes) < smem) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  int blocks_per_sm = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel,
                                                      kThreads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks_per_sm < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  plan[0] = static_cast<int>(staged);
  plan[1] = static_cast<int>(smem);
  plan[2] = sms * blocks_per_sm;
  plan[3] = blocks_per_sm;
  plan[4] = kThreads;
  return 0;
}

// Whether the host can launch a walk over `table` [sentinel, width]
// (16-byte aligned, width a multiple of 4 and at least the head's 40
// floats) with k slots of format fmt a leaf.
inline bool walk_args_ok(const float* table, long long sentinel, int width,
                         int k, int fmt) {
  return sentinel >= 1 && sentinel <= 0x7fffffffLL && width % 4 == 0 &&
         width >= 4 * kHeadChunks &&
         reinterpret_cast<uintptr_t>(table) % 16 == 0 && k >= 1 &&
         (fmt == kFmtBW || fmt == kFmtMT) &&
         kColBody + (fmt == kFmtMT ? kLeafStride<kFmtMT>
                                   : kLeafStride<kFmtBW>) * k <=
             width;
}

}  // namespace trt

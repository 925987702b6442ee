// Threaded-row BVH walks of the bounce engine for Hopper (sm_90a): one
// thread a ray walks the threaded rows to the end, closest hit or any
// hit.
//
// What it replaces.  On the TPU these are not Pallas kernels but
// XLA-fused jnp while_loops: closest_hit_packed and any_hit_packed
// (tryraytrace_tpu/ops/traverse.py:696,742), which advance every lane of
// the wave by one row of the threaded table per loop iteration.  Their
// plain PyTorch versions are the functions of the same names in
// tryraytrace_tpu_torch/ops/traverse.py, and the kernel is held to them
// exactly: every product and sum is rounded on its own (built with
// --fmad=false and no fast math, so 1.0f / x is IEEE), sums of three run
// left to right, min and max carry NaN as torch's do, and every tie is
// broken as the tensor code breaks it.
//
// The table is the walk-order copy of the threaded rows
// (accel/bvh.py threaded_walk_order_table): the rows of
// pack_traversal_table in breadth-first order, links renamed, each row
// padded to a multiple of 4 floats, so every row starts on a 16-byte
// boundary.  A row holds the node's box (0:6), K inline leaf slots from
// float 6, prim_start (-1 for an internal row), the leaf's count, then
// next_hit[8] and next_miss[8], the thread's continuations for each
// ray-direction octant (row ids; the row count is the end).  A walk
// fetches row `cur`, tests the box and, on a hit leaf, its slots; it goes
// on to next_hit of its octant after a hit internal box and to next_miss
// otherwise.
//   - Closest hit: the sign-preserving safe inverse (|d| < 1e-8 ->
//     +-1e20), the box window (0, d_min), the leaf window (0, d_min) with a
//     strict < update over slots j = 0..K-1, so the lowest slot wins a tie.
//   - Any hit: the plain 1/d (0 * inf = NaN in the slab test: a miss), the
//     box window (1e-3, max_dist), the leaf window (1e-3, max_dist - 1e-3),
//     and the walk stops at the first occluder.
// The leaf slot format is a template parameter, as in quad_walk.cu:
// Baldwin-Weber (n, v0, bu, bv), 12 floats, or Moller-Trumbore
// (v0, e1, e2), 9 floats; the slot tests are quad_walk.cu's.
//
// What bounds it on this card.  A walk knows its next row only after it
// has read the current one, so each thread runs a chain of dependent
// loads; the 32 lanes of a warp read 32 different rows; and walks differ
// in length, so a warp runs as long as its longest walk.  The table (3.8
// MB on the main path) stays in the 50 MB L2, so the bytes it must move
// are few; the time is each walk's chain of round trips and how many
// threads the card keeps waiting on theirs.  The design (PERF.md, each
// part measured in turns against the scalar-load kernel it replaced):
//   - One round trip a row.  A row's box (two 16-byte loads), prim_start
//     and both candidate links of the ray's octant (next_hit and
//     next_miss) are loaded in one batch of independent loads; the box
//     test then picks the link in registers.  A leaf's slots are loaded
//     only after its box is hit, two slots a batch ("bw" slots as the
//     16-byte units they span, "mt" slots a float at a time), so a hit
//     leaf of K slots costs K / 2 more round trips, not K.  Four slots a
//     batch take ~90 registers and halve the threads an SM keeps.
//   - Blocks of 64 threads, one a ray: a block ends with its longest
//     walk, so small blocks let the card replace finished rays sooner,
//     and a block of rays that are all inactive ends at once.  Persistent
//     blocks that claim rays from a global counter were built and
//     measured: faster by a sixth when 8% of the rays are alive, slower
//     by a fifth on full waves, so they went, as did staging the top
//     levels in shared memory and loading the first slots with the
//     header.
//
// Every lane's outputs are written here, so the caller allocates them
// without filling them.  The kernel counts the rows it fetches (a warp
// sum, then one 64-bit atomic add, which is free of order): the rows of
// this run's walks.  Launched on the caller's stream; allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace trt_threaded {

// Leaf slot formats (accel/bvh.py LEAF_FORMATS).
constexpr int kFmtBW = 0;  // Baldwin-Weber (n, v0, bu, bv)
constexpr int kFmtMT = 1;  // Moller-Trumbore (v0, e1, e2)
template <int F>
constexpr int kLeafStride = F == kFmtMT ? 9 : 12;

constexpr int kThreads = 64;
constexpr unsigned kFull = 0xffffffffu;

// Slots loaded in one batch.  A batch whose floats fill whole 16-byte
// units (two "bw" slots) starts 8 bytes into a unit (float 6 + stride *
// kGroup * g) and is loaded as the units it spans; another (two "mt"
// slots) is loaded a float at a time.
constexpr int kGroup = 2;
template <int F>
constexpr bool kGroupVec = (kGroup * kLeafStride<F>) % 4 == 0;
template <int F>
constexpr int kGroupUnits = (2 + kGroup * kLeafStride<F> + 3) / 4;

constexpr float kMissT = 1e20f;
constexpr float kEps = 1e-5f;
constexpr float kShadowTMin = 1e-3f;

// min and max that give NaN when either operand is NaN, as
// torch.minimum / maximum / amax / amin do (fminf / fmaxf drop the NaN):
// min.NaN / max.NaN, one instruction each on sm_80 and later.
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
  int octant;
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
// or 0 for a miss (ops/intersect.py moller_trumbore_pre).
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

// Slab test of a box (min xyz, max xyz) against (t_min, t_max):
// tmax >= tmin && tmax > t_min && tmin < t_max, false where NaN.
__device__ __forceinline__ bool box_hit(const float (&box)[6], const Ray& r,
                                        float t_min, float t_max) {
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t1 = (box[a] - r.o[a]) * r.inv[a];
    const float t2 = (box[3 + a] - r.o[a]) * r.inv[a];
    const float near_a = nan_min(t1, t2);
    const float far_a = nan_max(t1, t2);
    lo = a == 0 ? near_a : nan_max(lo, near_a);
    hi = a == 0 ? far_a : nan_min(hi, far_a);
  }
  return hi >= lo && hi > t_min && lo < t_max;
}

struct Params {
  const float4* table;  // walk-order rows, width4 16-byte units a row
  int width4;
  int col_ps;           // prim_start's column; the links follow it
  int sentinel;
  int k;
  long long n;
  const float* o;
  const float* d;
  const unsigned char* active;
  const float* max_dist;          // any hit only
  float* t_out;                   // closest hit only
  long long* id_out;              // closest hit only
  unsigned char* occ_out;         // any hit only
  unsigned long long* rows_out;
};

__device__ __forceinline__ float load1(const float4* row, int f) {
  return __ldg(reinterpret_cast<const float*>(row) + f);
}

// What a row's round trip brings: its box, prim_start and the two links
// of the ray's octant (column col_link and the one 8 after it).
struct Head {
  float box[6];
  float ps;
  float nh;
  float nm;
};

__device__ __forceinline__ Head load_head(const float4* row, int col_ps,
                                          int col_link) {
  const float4 b0 = __ldg(row);
  const float4 b1 = __ldg(row + 1);
  return Head{{b0.x, b0.y, b0.z, b0.w, b1.x, b1.y},
              load1(row, col_ps),
              load1(row, col_link),
              load1(row, col_link + 8)};
}

// Slot group g of a leaf row (slots kGroup * g ..): s[b] is slot
// kGroup * g + b, those at or past k left zero.
template <int F>
__device__ __forceinline__ void load_group(
    const float4* row, int width4, int k, int g,
    float (&s)[kGroup][kLeafStride<F>]) {
  constexpr int kStride = kLeafStride<F>;
  if constexpr (kGroupVec<F>) {
    const int u0 = (6 + kStride * kGroup * g) >> 2;
    float4 c[kGroupUnits<F>];
#pragma unroll
    for (int i = 0; i < kGroupUnits<F>; ++i) {
      c[i] = u0 + i < width4 ? __ldg(row + u0 + i)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
#pragma unroll
      for (int i = 0; i < kStride; ++i) {
        const int f = 2 + kStride * b + i;
        s[b][i] = part(c[f >> 2], f & 3);
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
      const int j = kGroup * g + b;
#pragma unroll
      for (int i = 0; i < kStride; ++i) {
        s[b][i] = j < k ? load1(row, 6 + kStride * j + i) : 0.0f;
      }
    }
  }
}

// The thread's walk of lane i, leaf slots of format F; kShadow picks the
// any hit.  Returns the rows it fetched.
template <int F, bool kShadow>
__device__ __forceinline__ unsigned walk(const Params& p, long long i) {
  if (!p.active[i]) {
    if (kShadow) {
      p.occ_out[i] = 0;
    } else {
      p.t_out[i] = kMissT;
      p.id_out[i] = -1;
    }
    return 0;
  }
  Ray r;
  r.octant = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = __ldg(p.o + 3 * i + a);
    r.d[a] = __ldg(p.d + 3 * i + a);
    if (kShadow) {
      r.inv[a] = 1.0f / r.d[a];
    } else {
      const bool tiny = fabsf(r.d[a]) < 1e-8f;
      const float q = 1.0f / (tiny ? 1.0f : r.d[a]);
      r.inv[a] = tiny ? (r.d[a] >= 0.0f ? 1e20f : -1e20f) : q;
    }
    if (r.d[a] < 0.0f) r.octant |= 1 << a;
  }
  constexpr int kStride = kLeafStride<F>;
  const float smax = kShadow ? __ldg(p.max_dist + i) : 0.0f;
  const int col_link = p.col_ps + 2 + r.octant;
  float d_min = kMissT;
  int hit_id = -1;
  bool occluded = false;
  unsigned rows = 0;
  int cur = 0;
  while (cur < p.sentinel && !occluded) {
    ++rows;
    const float4* row = p.table + static_cast<size_t>(cur) * p.width4;
    const Head h = load_head(row, p.col_ps, col_link);
    const bool hit = kShadow ? box_hit(h.box, r, kShadowTMin, smax)
                             : box_hit(h.box, r, 0.0f, d_min);
    const int prim_start = static_cast<int>(h.ps);
    const bool is_leaf = prim_start >= 0;
    if (hit && is_leaf) {
      const float thi = kShadow ? smax - kShadowTMin : d_min;
      float best_t = kMissT;
      int best = -1;
      for (int g = 0; g * kGroup < p.k && !occluded; ++g) {
        float s[kGroup][kStride];
        load_group<F>(row, p.width4, p.k, g, s);
#pragma unroll
        for (int b = 0; b < kGroup; ++b) {
          const int j = kGroup * g + b;
          if (j < p.k && !occluded) {
            const float t = slot_t<F>(s[b], r);
            if (kShadow) {
              occluded = t > kShadowTMin && t < thi;
            } else {
              const float cand = (t > 0.0f && t < thi) ? t : kMissT;
              if (cand < best_t) {
                best_t = cand;
                best = j;
              }
            }
          }
        }
      }
      if (!kShadow && best >= 0) {
        d_min = best_t;
        hit_id = prim_start + best;
      }
    }
    cur = static_cast<int>(hit && !is_leaf ? h.nh : h.nm);
  }
  if (kShadow) {
    p.occ_out[i] = occluded ? 1 : 0;
  } else {
    p.t_out[i] = d_min;
    p.id_out[i] = hit_id;
  }
  return rows;
}

// One thread per lane i.
template <int F, bool kShadow>
__global__ void __launch_bounds__(kThreads)
    threaded_walk_kernel(const Params p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long rows = i < p.n ? walk<F, kShadow>(p, i) : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rows += __shfl_down_sync(kFull, rows, off);
  }
  if ((threadIdx.x & 31) == 0 && rows > 0) atomicAdd(p.rows_out, rows);
}

inline int leaf_stride(int fmt) {
  return fmt == kFmtMT ? kLeafStride<kFmtMT> : kLeafStride<kFmtBW>;
}

template <int F, bool kShadow>
void launch(const Params& p, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((p.n + kThreads - 1) / kThreads);
  threaded_walk_kernel<F, kShadow><<<blocks, kThreads, 0, st>>>(p);
}

}  // namespace trt_threaded

// table [sentinel, width] float32, 16-byte aligned, width a multiple of 4:
// threaded rows in walk order (accel/bvh.py threaded_walk_order_table)
// with k slots of format `fmt` (0 Baldwin-Weber, 1 Moller-Trumbore) per
// leaf.  n rays: o, d [n, 3] float32, active [n] bool bytes, and for the
// any hit (max_dist non-null) max_dist [n] float32, the NEE segment's
// length less its epsilon.  The closest hit writes t [n] float32 (1e20 on
// a miss) and id [n] int64 (-1 on a miss), the any hit occluded [n] bool
// bytes, for every lane; rows (one int64, zero at launch) is incremented
// by the rows fetched.  Returns the CUDA error of the launch (0 =
// launched), 1 (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int trt_threaded_walk_launch(
    const float* table, long long sentinel, int width, int k, int fmt,
    long long n, const float* o, const float* d, const unsigned char* active,
    const float* max_dist, float* t_out, long long* id_out,
    unsigned char* occ_out, long long* rows, void* stream) {
  using namespace trt_threaded;
  if (n <= 0) return 0;
  const bool shadow = max_dist != nullptr;
  if (sentinel < 0 || sentinel > 0x7fffffffLL || width % 4 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 || k < 1 ||
      (fmt != kFmtBW && fmt != kFmtMT) ||
      leaf_stride(fmt) * k + 24 > width ||
      (shadow ? occ_out == nullptr
              : (t_out == nullptr || id_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{reinterpret_cast<const float4*>(table),
           width / 4,
           6 + leaf_stride(fmt) * k,
           static_cast<int>(sentinel),
           k,
           n,
           o,
           d,
           active,
           max_dist,
           t_out,
           id_out,
           occ_out,
           reinterpret_cast<unsigned long long*>(rows)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == kFmtMT) {
    shadow ? launch<kFmtMT, true>(p, st) : launch<kFmtMT, false>(p, st);
  } else {
    shadow ? launch<kFmtBW, true>(p, st) : launch<kFmtBW, false>(p, st);
  }
  return static_cast<int>(cudaGetLastError());
}

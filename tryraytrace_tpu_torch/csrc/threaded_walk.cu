// Threaded-row BVH walks of the bounce engine for Hopper (sm_90a): one
// thread per ray walks the threaded rows to the end, closest hit or any
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
// The table (accel/bvh.py pack_traversal_table) holds one row per node of
// the binary tree, stride * K + 24 floats: the node's box (0:6), K inline
// leaf slots from float 6, prim_start (-1 for an internal row), the leaf's
// count, then next_hit[8] and next_miss[8], the thread's continuations for
// each ray-direction octant (node ids; the row count is the end).  A walk
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
// loads; the 32 lanes of a warp read 32 different rows, so no load is
// coalesced; and walks differ in length, so a warp runs as long as its
// longest walk.  The table itself is small (4 MB on the main path) and
// stays in the 50 MB L2 after the first walks, so the bytes it must move
// are few and the time is load latency and instructions a row.  The
// design is the simple one: rows are 9K + 24 floats for "mt" slots, not
// always a multiple of 4 (78 at K = 6), so the kernel reads one float at
// a time, and only what the row's kind needs: the box, prim_start and
// one link of an internal row (8 loads), a leaf's slots only when its
// box is hit.  Persistent threads that take new rays as theirs finish,
// and the top rows in shared memory (quad_walk.cu's answers to the same
// costs), are later work.
//
// The kernel counts the rows it fetches (a warp sum, then one 64-bit
// atomic add, which is free of order): the operations of this run's
// walks, which give its bound.  Launched on the caller's stream;
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace trt_threaded {

// Leaf slot formats (accel/bvh.py LEAF_FORMATS).
constexpr int kFmtBW = 0;  // Baldwin-Weber (n, v0, bu, bv)
constexpr int kFmtMT = 1;  // Moller-Trumbore (v0, e1, e2)
template <int F>
constexpr int kLeafStride = F == kFmtMT ? 9 : 12;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
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

// Slot j of format F of a leaf row: t, or 0 for a miss.
template <int F>
__device__ __forceinline__ float slot_t(const float* __restrict__ row, int j,
                                        const Ray& r) {
  constexpr int kStride = kLeafStride<F>;
  float s[kStride];
#pragma unroll
  for (int i = 0; i < kStride; ++i) s[i] = __ldg(row + 6 + kStride * j + i);
  if constexpr (F == kFmtMT) {
    return moller_trumbore_t(s, r);
  } else {
    return baldwin_t(s, r);
  }
}

// Slab test of a row's box against (t_min, t_max):
// tmax >= tmin && tmax > t_min && tmin < t_max, false where NaN.
__device__ __forceinline__ bool box_hit(const float* __restrict__ row,
                                        const Ray& r, float t_min,
                                        float t_max) {
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t1 = (__ldg(row + a) - r.o[a]) * r.inv[a];
    const float t2 = (__ldg(row + 3 + a) - r.o[a]) * r.inv[a];
    const float near_a = nan_min(t1, t2);
    const float far_a = nan_max(t1, t2);
    lo = a == 0 ? near_a : nan_max(lo, near_a);
    hi = a == 0 ? far_a : nan_min(hi, far_a);
  }
  return hi >= lo && hi > t_min && lo < t_max;
}

struct Params {
  const float* __restrict__ table;
  int sentinel;
  int width;
  int k;
  long long n;
  const float* __restrict__ o;
  const float* __restrict__ d;
  const unsigned char* __restrict__ active;
  const float* __restrict__ max_dist;  // any hit only
  float* t_out;                        // closest hit only
  long long* id_out;                   // closest hit only
  unsigned char* occ_out;              // any hit only
  unsigned long long* rows_out;
};

// One thread per ray i; kShadow picks the any-hit walk.
template <int F, bool kShadow>
__global__ void __launch_bounds__(kThreads)
    threaded_walk_kernel(const Params p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long rows = 0;
  if (i < p.n) {
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
    const int col_ps = 6 + kLeafStride<F> * p.k;
    const float smax = kShadow ? __ldg(p.max_dist + i) : 0.0f;
    const float leaf_hi = smax - 1e-3f;
    float d_min = kMissT;
    long long hit_id = -1;
    bool occluded = false;
    int cur = __ldg(p.active + i) ? 0 : p.sentinel;
    while (cur < p.sentinel) {
      ++rows;
      const float* __restrict__ row =
          p.table + static_cast<size_t>(cur) * p.width;
      const bool hit = kShadow ? box_hit(row, r, kShadowTMin, smax)
                               : box_hit(row, r, 0.0f, d_min);
      const int prim_start = static_cast<int>(__ldg(row + col_ps));
      const bool is_leaf = prim_start >= 0;
      if (hit && is_leaf) {
        if (kShadow) {
          for (int j = 0; j < p.k; ++j) {
            const float t = slot_t<F>(row, j, r);
            if (t > kShadowTMin && t < leaf_hi) {
              occluded = true;
              break;
            }
          }
          if (occluded) break;
        } else {
          float best_t = kMissT;
          int best = -1;
          for (int j = 0; j < p.k; ++j) {
            const float t = slot_t<F>(row, j, r);
            const float cand = (t > 0.0f && t < d_min) ? t : kMissT;
            if (cand < best_t) {
              best_t = cand;
              best = j;
            }
          }
          if (best >= 0) {
            d_min = best_t;
            hit_id = prim_start + best;
          }
        }
      }
      const int link = (hit && !is_leaf ? 2 : 10) + r.octant;
      cur = static_cast<int>(__ldg(row + col_ps + link));
    }
    if (kShadow) {
      p.occ_out[i] = occluded ? 1 : 0;
    } else {
      p.t_out[i] = d_min;
      p.id_out[i] = hit_id;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rows += __shfl_down_sync(kFull, rows, off);
  }
  if ((threadIdx.x & 31) == 0 && rows > 0) atomicAdd(p.rows_out, rows);
}

// Arguments the kernels do not take: cudaErrorInvalidValue.
inline bool bad_args(long long sentinel, int width, int k, int fmt,
                     long long n) {
  if (fmt != kFmtBW && fmt != kFmtMT) return true;
  const int stride = fmt == kFmtMT ? kLeafStride<kFmtMT> : kLeafStride<kFmtBW>;
  return sentinel < 1 || sentinel > 0x7fffffffLL || k < 1 ||
         width < stride * k + 24 || n < 0;
}

template <bool kShadow>
int launch(const Params& p, int fmt, void* stream) {
  if (p.n == 0) return 0;
  const long long blocks = (p.n + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == kFmtMT) {
    threaded_walk_kernel<kFmtMT, kShadow>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  } else {
    threaded_walk_kernel<kFmtBW, kShadow>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace trt_threaded

// Closest hit.  table [sentinel, width] float32 threaded rows with k
// slots of format `fmt` (0 Baldwin-Weber, 1 Moller-Trumbore) per leaf; n
// rays: o, d [n, 3] float32, active [n] bool bytes; writes t [n] float32
// (1e20 on a miss) and id [n] int64 (-1 on a miss); rows (one int64, zero
// at launch) is incremented by the rows fetched.  Returns the CUDA error
// of the launch (0 = launched), 1 (cudaErrorInvalidValue) for arguments
// it does not take.
extern "C" int trt_threaded_closest_launch(
    const float* table, long long sentinel, int width, int k, int fmt,
    long long n, const float* o, const float* d, const unsigned char* active,
    float* t_out, long long* id_out, long long* rows, void* stream) {
  if (trt_threaded::bad_args(sentinel, width, k, fmt, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  trt_threaded::Params p{table, static_cast<int>(sentinel), width, k, n,
                         o, d, active, nullptr, t_out, id_out, nullptr,
                         reinterpret_cast<unsigned long long*>(rows)};
  return trt_threaded::launch<false>(p, fmt, stream);
}

// Any hit, as above with max_dist [n] float32 (the NEE segment's length
// less its epsilon); writes occluded [n] bool bytes.
extern "C" int trt_threaded_any_launch(
    const float* table, long long sentinel, int width, int k, int fmt,
    long long n, const float* o, const float* d, const float* max_dist,
    const unsigned char* active, unsigned char* occ_out, long long* rows,
    void* stream) {
  if (trt_threaded::bad_args(sentinel, width, k, fmt, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  trt_threaded::Params p{table, static_cast<int>(sentinel), width, k, n,
                         o, d, active, max_dist, nullptr, nullptr, occ_out,
                         reinterpret_cast<unsigned long long*>(rows)};
  return trt_threaded::launch<true>(p, fmt, stream);
}

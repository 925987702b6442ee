// Quad-row BVH walk for Hopper (sm_90a): one thread per lane runs the
// lane's whole walk in one launch.
//
// On the TPU the walk is not a Pallas kernel: it is the walk half of
// _step_quad (tryraytrace_tpu/engine/persistent.py), XLA-fused jnp that
// advances every lane by one table row per loop iteration.  This is the
// hand kernel for that code.  Its plain version is walk_plain
// (tryraytrace_tpu_torch/ops/walk.py), the eager PyTorch step repeated
// until no lane walks, and the kernel is held to it exactly: every
// product and sum below is rounded on its own (built with --fmad=false,
// no fast math, so 1.0f / x is IEEE), sums of three run left to right,
// and every tie is broken as the tensor code breaks it.
//
// A lane in mode TRAVERSE walks for its closest hit, a lane in mode SHADOW
// for any hit along its NEE segment; a SHADOW lane whose path continues
// becomes TRAVERSE and walks on in the same launch.  Lanes in other modes
// are left alone.  Per fetched row: a leaf row tests its K Baldwin-Weber
// triangles, an internal row its four child boxes in the octant's
// front-to-back order; the first hit child is entered, later siblings that
// were missed go into the skip-register file, and the file redirects the
// walk past an entry when the thread order would enter it.  The registers
// live in the thread.
//
// What bounds it: the rows.  Each step needs a table row (300 B wide on
// the main path, read from L2: the 10 MB table stays resident) before it
// knows the next row, so a lane is a chain of dependent fetches, and the
// lanes of a warp read 32 different rows with 4-byte loads (a 300-byte
// row is not 16-byte aligned).  Threads of a warp also walk for different
// lengths.  Both are accepted here: right and simple first.  The kernel
// counts the rows it fetches (a block reduce, then one 64-bit atomic add,
// which is free of order), which gives the bound it is measured against.
//
// The row decode, the leaf test and the register file are __device__
// functions in namespace trt, for the state-machine kernel that takes the
// shading in as well.
//
// Launched on the caller's stream; allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int kLeafStride = 12; // floats per Baldwin-Weber slot

constexpr float kMissT = 1e20f;
constexpr float kEps = 1e-5f;
constexpr float kShadowTMin = 1e-3f;

// min and max that give NaN when either operand is NaN, as
// torch.minimum / maximum / amax / amin do.  The shadow walk's plain 1/d
// makes 0 * inf = NaN in the slab test, and the comparisons must then say
// "miss"; fminf / fmaxf would drop the NaN and could say "hit".
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  float t_min;
  int octant;
};

// The walk's ray.  The closest-hit walk uses the sign-preserving safe
// inverse (|d| < 1e-8 -> +-1e20), the shadow walk a plain reciprocal.
__device__ __forceinline__ Ray make_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        bool shadow) {
  Ray r;
  r.octant = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r.o[i] = o[i];
    r.d[i] = d[i];
    const bool tiny = fabsf(d[i]) < 1e-8f && !shadow;
    const float q = 1.0f / (tiny ? 1.0f : d[i]);
    r.inv[i] = tiny ? (d[i] >= 0.0f ? 1e20f : -1e20f) : q;
    if (d[i] < 0.0f) r.octant |= 1 << i;
  }
  r.t_min = shadow ? kShadowTMin : 0.0f;
  return r;
}

// Baldwin-Weber ray/triangle test on one 12-float slot (n, v0, bu, bv):
// t, or 0 for a miss.  An all-zero pad slot misses by the parallel guard.
__device__ __forceinline__ float baldwin_t(const float* __restrict__ s,
                                           const Ray& r) {
  const float n0 = __ldg(s + 0), n1 = __ldg(s + 1), n2 = __ldg(s + 2);
  const float nd = (n0 * r.d[0] + n1 * r.d[1]) + n2 * r.d[2];
  const bool parallel = fabsf(nd) < kEps;
  const float f = 1.0f / (parallel ? 1.0f : nd);
  const float s0 = r.o[0] - __ldg(s + 3);
  const float s1 = r.o[1] - __ldg(s + 4);
  const float s2 = r.o[2] - __ldg(s + 5);
  const float t = (-f) * ((n0 * s0 + n1 * s1) + n2 * s2);
  const float p0 = s0 + t * r.d[0];
  const float p1 = s1 + t * r.d[1];
  const float p2 = s2 + t * r.d[2];
  const float u = (__ldg(s + 6) * p0 + __ldg(s + 7) * p1) + __ldg(s + 8) * p2;
  const float v =
      (__ldg(s + 9) * p0 + __ldg(s + 10) * p1) + __ldg(s + 11) * p2;
  const bool valid =
      !parallel && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kEps;
  return valid ? t : 0.0f;
}

// Closest hit among a leaf row's k slots inside the open window
// (tlo, thi): the lowest slot wins a tie in t (strict <).  Returns the
// slot, or -1 when none hits; best_t is then kMissT.
__device__ __forceinline__ int leaf_test(const float* __restrict__ row, int k,
                                         const Ray& r, float tlo, float thi,
                                         float& best_t) {
  best_t = kMissT;
  int best = -1;
  for (int j = 0; j < k; ++j) {
    const float t = baldwin_t(row + kColBody + kLeafStride * j, r);
    const float cand = (t > tlo && t < thi) ? t : kMissT;
    if (cand < best_t) {
      best_t = cand;
      best = j;
    }
  }
  return best;
}

// Slab test of one child box (min xyz, max xyz) against (t_min, t_max).
__device__ __forceinline__ bool box_hit(const float* __restrict__ b,
                                        const Ray& r, float t_max) {
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float t1 = (__ldg(b + i) - r.o[i]) * r.inv[i];
    const float t2 = (__ldg(b + 3 + i) - r.o[i]) * r.inv[i];
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

__device__ __forceinline__ Decode quad_decode(const float* __restrict__ row,
                                              const Ray& r, int cont,
                                              int perm, float t_max) {
  const float* body = row + kColBody;
  int hits = 0;
  int ents[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (box_hit(body + 6 * c, r, t_max)) hits |= 1 << c;
    ents[c] = static_cast<int>(__ldg(body + kBodyEnt + c));
  }
  const int nsl = static_cast<int>(
      fminf(fmaxf(__ldg(body + kBodyNslots), 0.0f), 4.0f));
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

// One walk from row `cur` to its end.  Closest hit (shadow false): updates
// d_min and hit_id.  Any hit (shadow true): returns true when occluded.
// Counts the rows it fetched into `rows`.
template <int R>
__device__ __forceinline__ bool walk(const float* __restrict__ table,
                                     int width, int sentinel, int k,
                                     int passes, const Ray& r, bool shadow,
                                     float smax, int& cur, float& d_min,
                                     long long& hit_id,
                                     unsigned long long& rows) {
  RegFile<R> regs;
  regs.clear();
  for (;;) {
    if (cur == 0) regs.clear();
    const int idx = cur < sentinel - 1 ? cur : sentinel - 1;
    const float* row = table + static_cast<size_t>(idx) * width;
    ++rows;
    const int prim_start = static_cast<int>(__ldg(row));
    const bool is_leaf = prim_start >= 0;
    const int cpi = static_cast<int>(__ldg(row + kColCont + r.octant));
    const int cont = cpi >> 8;
    int next = cont;
    bool occluded = false;
    if (is_leaf) {
      float best_t;
      const float thi = shadow ? smax - kShadowTMin : d_min;
      const int slot = leaf_test(row, k, r, r.t_min, thi, best_t);
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
          quad_decode(row, r, cont, cpi & 255, shadow ? smax : d_min);
      next = dec.next;
      regs.push(dec);
    }
    cur = regs.redirect(next, passes);
    if (occluded) return true;
    if (cur >= sentinel) return false;
  }
}

template <int R>
__global__ void quad_walk_kernel(
    const float* __restrict__ table, int width, int sentinel, int k,
    int passes, long long n, long long* __restrict__ mode_io,
    long long* __restrict__ cur_io, long long* __restrict__ hit_id_io,
    float* __restrict__ d_min_io, float* __restrict__ rad_io,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ so, const float* __restrict__ sd,
    const float* __restrict__ smax_in, const float* __restrict__ pend,
    const unsigned char* __restrict__ cont_after_shadow,
    unsigned long long* __restrict__ rows_out) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned long long rows = 0;
  if (lane < n) {
    long long mode = mode_io[lane];
    if (mode == kTraverse || mode == kShadow) {
      const long long cur64 = cur_io[lane];
      int cur = cur64 < sentinel ? static_cast<int>(cur64) : sentinel;
      float d_min = d_min_io[lane];
      long long hit_id = hit_id_io[lane];
      if (mode == kShadow) {
        const Ray r = make_ray(so + 3 * lane, sd + 3 * lane, true);
        const bool occluded = walk<R>(table, width, sentinel, k, passes, r,
                                      true, smax_in[lane], cur, d_min, hit_id,
                                      rows);
        // The plain step adds where(lit, pend, 0.0): a finished shadow
        // lane's rad gets + 0.0 when occluded.
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          rad_io[3 * lane + i] =
              rad_io[3 * lane + i] + (occluded ? 0.0f : pend[3 * lane + i]);
        }
        mode = cont_after_shadow[lane] ? kTraverse : kRefill;
        cur = 0;
        d_min = kMissT;
        hit_id = -1;
      }
      if (mode == kTraverse) {
        const Ray r = make_ray(o + 3 * lane, d + 3 * lane, false);
        walk<R>(table, width, sentinel, k, passes, r, false, 0.0f, cur, d_min,
                hit_id, rows);
        mode = hit_id >= 0 ? kShadeG : kRefill;
      }
      mode_io[lane] = mode;
      cur_io[lane] = cur;
      d_min_io[lane] = d_min;
      hit_id_io[lane] = hit_id;
    }
  }

  // Rows fetched: warp shuffle, one slot per warp, one atomic per block.
  __shared__ unsigned long long warp_rows[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rows += __shfl_down_sync(0xffffffffu, rows, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_rows[warp] = rows;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    const int warps = (blockDim.x + 31) >> 5;
    for (int i = 0; i < warps; ++i) total += warp_rows[i];
    if (total) atomicAdd(rows_out, total);
  }
}

template <int R>
int launch_walk(const float* table, int width, int sentinel, int k,
                int passes, long long n, long long* mode, long long* cur,
                long long* hit_id, float* d_min, float* rad, const float* o,
                const float* d, const float* so, const float* sd,
                const float* smax, const float* pend,
                const unsigned char* cont_after_shadow,
                unsigned long long* rows_out, cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  quad_walk_kernel<R><<<static_cast<unsigned int>(blocks), threads, 0,
                        stream>>>(table, width, sentinel, k, passes, n, mode,
                                  cur, hit_id, d_min, rad, o, d, so, sd, smax,
                                  pend, cont_after_shadow, rows_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace trt

// table [table_rows, width] float32, its first `sentinel` rows quad rows
// with k triangles per leaf; n lanes.  mode, cur, hit_id (int64), d_min
// [n] and rad [n, 3] (float32) are read and written; o, d, so, sd, pend
// [n, 3], smax [n] (float32) and cont_after_shadow [n] (bool bytes) are
// read; *rows_out (int64) is incremented by the rows fetched.  Returns the
// CUDA error of the launch (0 = launched), 1 (cudaErrorInvalidValue) for
// arguments it does not take.
extern "C" int trt_quad_walk_launch(
    const float* table, long long table_rows, int width, long long sentinel,
    int k, int regs, int passes, long long n, long long* mode, long long* cur,
    long long* hit_id, float* d_min, float* rad, const float* o,
    const float* d, const float* so, const float* sd, const float* smax,
    const float* pend, const unsigned char* cont_after_shadow,
    long long* rows_out, void* stream) {
  if (n <= 0) return 0;
  if (sentinel < 1 || sentinel > table_rows || sentinel > 0x7fffffffLL ||
      k < 1 || trt::kColBody + trt::kLeafStride * k > width ||
      trt::kColBody + trt::kBodyNslots >= width || passes < 1 ||
      n > 0x7fffffffLL * 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* rows = reinterpret_cast<unsigned long long*>(rows_out);
  const int sent = static_cast<int>(sentinel);
#define TRT_WALK(R)                                                        \
  case R:                                                                  \
    return trt::launch_walk<R>(table, width, sent, k, passes, n, mode, cur, \
                               hit_id, d_min, rad, o, d, so, sd, smax,     \
                               pend, cont_after_shadow, rows, st)
  switch (regs) {
    TRT_WALK(0);
    TRT_WALK(3);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRT_WALK
}

// The persistent engine's lane set-up for Hopper (sm_90a): a wave's fresh
// lane state in one launch, written a tile of 256 lanes at a time in
// whole 32-byte sectors.
//
// What it replaces.  On the TPU the set-up is part of the engine's
// jitted XLA program: init_lane_ctx (tryraytrace_tpu/engine/
// persistent.py:167, called inside the jitted frame at :355, and by the
// progressive engine, progressive.py:207) with generate_rays
// (tryraytrace_tpu/engine/camera_rays.py:21); it is not a Pallas kernel.
// Its plain version is tryraytrace_tpu_torch/engine/persistent.py
// init_lane_ctx, some twenty eager launches (fills, the seed schedule,
// three PCG hashes and the camera ray's float64-routed sqrt, cos and
// sin over every lane), and the kernel is held to it field for field,
// bit for bit: the camera ray is service_device.cuh's camera_ray, which
// the wave kernel's refill already holds to the eager _refill, so every
// product and sum is rounded on its own (built with --fmad=false, no
// fast math), sqrt, cos and sin are taken in double and rounded once,
// and the raster divisions are IEEE divisions by the float32 sides.
//
// Per lane i (pixel pix = first + i for a contiguous range, else the
// caller's pix[i]):
//   mode TRAVERSE, cur 0, d_min MISS_T, hit_id -1, (o, d) the camera ray
//   of (pix, seed0), tp 1, rad, so, sd, pend, out +0.0, smax 0, sample 0,
//   seed seed0, depth 0, prev_spec 1, cont_after_shadow 0, the texture
//   stash 0 (textured tables only) and the skip registers reg_e and
//   reg_s -1 (regs columns each, none when regs is 0).  seed0 is the
//   seed schedule's sample 0, the u32 sum of the packed seed base and the
//   sample offset (core/rng.py sample_seed), the same for every lane.
//   Thread 0 of block 0 also sets the wave's int64 totals (ops/service.py
//   TOTALS) to [n, 0, 0, 0] and its rows to 0, so the host copies nothing
//   to the card.
//
// What bounds it on this card.  Bytes written: 250 B a lane on the main
// path (202 B of state with the texture stash, 48 B of skip registers at
// 3 a lane), ~240 MB for 960,000 lanes, 0.072 ms at 3.35 TB/s.  Its
// arithmetic is a few double sqrt, cos and sin calls a lane, far below
// that at the card's FP64 rate.  Stored one thread a lane, 4 bytes at a
// time, the [n, 3] and [n, 10] fields come out strided (12 or 40 B
// between a warp's threads): a warp of 32 lanes then sends L2 898 sector
// writes, each a part of a sector, for the 250 sectors it fills, and
// L2's request rate, not device memory, sets the time.
//
// What the design does about it.  Each warp store writes whole,
// contiguous sectors, 16 bytes a thread: 250 sector writes for a warp's
// worth of lanes.  A block takes a tile of 256 lanes, which is a span of
// k * e * 256 bytes of each field with k elements of e bytes a lane (a
// multiple of 16, so each span is 16-byte aligned when the field is;
// the wrapper refuses a field that is not).
//   - The fields that do not depend on the lane (all but o, d and pix;
//     seed0 is one value for the wave) are fills of the tile's span, one
//     16-byte piece a thread a store.
//   - pix = first + i, contiguous int64, goes two lanes a 16-byte store;
//     a given pix is read, one lane a thread.
//   - Each thread computes its lane's (o, d) with camera_ray and puts it
//     in a 256 x 3 float tile in shared memory for each field (6 KB a
//     block); after a barrier the block writes the tiles out as 16-byte
//     stores.  One bulk asynchronous copy a tile (cp.async.bulk) instead
//     took the same time on an H100 (PERF.md) and was dropped.
//   - The last tile of a wave whose lanes are not a multiple of 256
//     stores up to exactly its last lane: 16-byte pieces where they fit,
//     one scalar store a thread for the elements past them.
//   - The grid is the blocks the card holds at once (SMs x resident
//     blocks, cudaOccupancyMaxActiveBlocksPerMultiprocessor, worked out
//     once a device), fewer when the wave has fewer tiles; the blocks
//     stride over the tiles, so no last wave of blocks runs half empty.
// No atomics.  Launched on the caller's stream; allocates nothing.

#include "service_device.cuh"

namespace trt_service {

constexpr int kTile = kThreads;  // lanes a block's tile
constexpr int kMaxDevices = 64;  // devices whose grid is kept

struct LaneInit {
  long long first;  // pixel of lane 0 for a contiguous range, -1: read pix
  long long* pix;   // written for a range, read otherwise
  long long* reg_e;
  long long* reg_s;
  int regs;
  long long* rows;
};

// Elements [k * lane0, k * (lane0 + lanes)) of a field with k elements of
// T a lane set to `value`: the whole 16-byte pieces with one store a
// thread each, then the fewer than 16 / sizeof(T) elements past them with
// one scalar store a thread.  `field` is 16-byte aligned and lane0 a
// multiple of kTile, so the span starts on a piece.
template <typename T>
__device__ __forceinline__ void fill(T* field, int k, long long lane0,
                                     int lanes, T value) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  union {
    T v[kPer];
    int4 q;
  } piece;
#pragma unroll
  for (int j = 0; j < kPer; ++j) piece.v[j] = value;
  T* span = field + k * lane0;
  const int count = k * lanes;
  const int whole = count / kPer;
  int4* span4 = reinterpret_cast<int4*>(span);
  for (int c = threadIdx.x; c < whole; c += kThreads) span4[c] = piece.q;
  const int rest = whole * kPer + static_cast<int>(threadIdx.x);
  if (rest < count) span[rest] = value;
}

// The tile's camera rays, o and d of lanes [lane0, lane0 + lanes) in
// shared memory, to their fields' spans.
__device__ __forceinline__ void store_rays(const Params& p, long long lane0,
                                           int lanes, const float* o,
                                           const float* d) {
  float* const to_o = p.o + 3 * lane0;
  float* const to_d = p.d + 3 * lane0;
  const int count = 3 * lanes;
  const int whole = count / 4;  // 16-byte pieces of a field's span
  for (int c = threadIdx.x; c < 2 * whole; c += kThreads) {
    const bool is_d = c >= whole;
    const int at = is_d ? c - whole : c;
    reinterpret_cast<float4*>(is_d ? to_d : to_o)[at] =
        reinterpret_cast<const float4*>(is_d ? d : o)[at];
  }
  const int t = static_cast<int>(threadIdx.x);
  const int rest = 4 * whole + (t >> 1);
  if (t < 8 && rest < count) {
    if (t & 1) {
      to_d[rest] = d[rest];
    } else {
      to_o[rest] = o[rest];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    lane_init_kernel(const Params p, const LaneInit q) {
  __shared__ __align__(16) float rays[2][3 * kTile];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.totals[kPathRays] = static_cast<unsigned long long>(p.n);
    p.totals[kShadowRays] = 0ull;
    p.totals[kLive] = 0ull;
    p.totals[kLive + 1] = 0ull;
    *q.rows = 0;
  }
  const unsigned seed = static_cast<unsigned>(p.i[kSeedBase]) +
                        static_cast<unsigned>(p.i[kSampleOffset]);
  const long long tiles = (p.n + kTile - 1) / kTile;
  const int t = static_cast<int>(threadIdx.x);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long lane0 = tile * kTile;
    const int lanes = static_cast<int>(
        p.n - lane0 < kTile ? p.n - lane0 : static_cast<long long>(kTile));
    const bool mine = t < lanes;
    V3 r_o = v3(0.0f, 0.0f, 0.0f), r_d = r_o;
    if (mine) {
      const long long i = lane0 + t;
      camera_ray(p, q.first >= 0 ? q.first + i : q.pix[i], seed, &r_o, &r_d);
    }
    if (q.first >= 0) {
      long long* span = q.pix + lane0;
      const long long v = q.first + lane0 + 2 * t;
      if (2 * t + 1 < lanes) {
        reinterpret_cast<longlong2*>(span)[t] = make_longlong2(v, v + 1);
      } else if (2 * t < lanes) {
        span[2 * t] = v;
      }
    }
    fill(p.mode, 1, lane0, lanes, kTraverse);
    fill(p.cur, 1, lane0, lanes, 0ll);
    fill(p.hit_id, 1, lane0, lanes, -1ll);
    fill(p.depth, 1, lane0, lanes, 0ll);
    fill(p.sample, 1, lane0, lanes, 0ll);
    fill(p.seed, 1, lane0, lanes, static_cast<long long>(seed));
    fill(p.d_min, 1, lane0, lanes, kMissT);
    fill(p.tp, 3, lane0, lanes, 1.0f);
    fill(p.rad, 3, lane0, lanes, 0.0f);
    fill(p.so, 3, lane0, lanes, 0.0f);
    fill(p.sd, 3, lane0, lanes, 0.0f);
    fill(p.smax, 1, lane0, lanes, 0.0f);
    fill(p.pend, 3, lane0, lanes, 0.0f);
    fill(p.out, 3, lane0, lanes, 0.0f);
    if (p.tstash != nullptr) fill(p.tstash, 10, lane0, lanes, 0.0f);
    fill(p.prev_spec, 1, lane0, lanes, static_cast<unsigned char>(1));
    fill(p.cont_after_shadow, 1, lane0, lanes, static_cast<unsigned char>(0));
    if (q.regs > 0) {
      fill(q.reg_e, q.regs, lane0, lanes, -1ll);
      fill(q.reg_s, q.regs, lane0, lanes, -1ll);
    }
    __syncthreads();  // the previous tile's rays are out of shared memory
    if (mine) {
      rays[0][3 * t] = r_o.x;
      rays[0][3 * t + 1] = r_o.y;
      rays[0][3 * t + 2] = r_o.z;
      rays[1][3 * t] = r_d.x;
      rays[1][3 * t + 1] = r_d.y;
      rays[1][3 * t + 2] = r_d.z;
    }
    __syncthreads();
    store_rays(p, lane0, lanes, rays[0], rays[1]);
  }
}

// The kernel's launch plan on the current device: SMs, resident blocks
// an SM, and the grid that fills the card (their product), worked out
// once a device.  Returns a CUDA error (0 = done).
int plan(int* sms, int* per_sm, int* grid) {
  static int kept[kMaxDevices][2];  // SMs, blocks an SM; 0: not yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && kept[dev][1] > 0) {
    *sms = kept[dev][0];
    *per_sm = kept[dev][1];
  } else {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, lane_init_kernel, kThreads, 0);
    }
    if (e == cudaSuccess && (*sms < 1 || *per_sm < 1)) {
      e = cudaErrorInvalidConfiguration;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) {
      kept[dev][0] = *sms;
      kept[dev][1] = *per_sm;
    }
  }
  *grid = *sms * *per_sm;
  return 0;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace trt_service

// The sizes of the parameter arrays trt_lane_init_launch reads, for the
// caller to check against its own: floats, ints, pointers, totals.
extern "C" int trt_lane_init_layout(int* out) {
  out[0] = trt_service::kNumFloats;
  out[1] = trt_service::kNumInts;
  out[2] = trt_service::kNumPtrs;
  out[3] = trt_service::kNumTotals;
  return 0;
}

// The launch plan on the current device: out = [SMs, resident blocks an
// SM, grid (blocks launched at most), static shared bytes a block].
// Returns a CUDA error (0 = done).
extern "C" int trt_lane_init_plan(int* out) {
  using namespace trt_service;
  int sms = 0, per_sm = 0, grid = 0;
  const int e = plan(&sms, &per_sm, &grid);
  if (e != 0) return e;
  cudaFuncAttributes attr;
  const cudaError_t a = cudaFuncGetAttributes(&attr, lane_init_kernel);
  if (a != cudaSuccess) return static_cast<int>(a);
  out[0] = sms;
  out[1] = per_sm;
  out[2] = grid;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

// Fresh state for n lanes on `stream`.  floats / ints / ptrs are the
// service kernel's (ops/service.py ServiceParams and state_pointers: the
// unified table, the light rows, the texture metas, the state fields,
// the totals); reg_e / reg_s are the skip registers, int64 [n, regs]
// (null when regs is 0); first >= 0 writes pix = first + lane, -1 reads
// the state's pix; rows is the wave's int64 row count.  Every field the
// kernel writes is 16-byte aligned (a pix it reads need not be).
// Launches for n == 0 too, to set the totals and rows.  Returns the CUDA
// error of the launch (0 = launched), 1 (cudaErrorInvalidValue) for
// arguments it does not take.
extern "C" int trt_lane_init_launch(const float* floats, const long long* ints,
                                    void* const* ptrs, long long* reg_e,
                                    long long* reg_s, int regs,
                                    long long first, long long n,
                                    long long* rows, void* stream) {
  using namespace trt_service;
  Params p;
  if (!unpack_params(floats, ints, ptrs, n, 0, &p) || regs < 0 ||
      n < 0 || first < -1 || rows == nullptr ||
      (regs > 0 && (reg_e == nullptr || reg_s == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* written[] = {p.mode, p.cur, p.hit_id, p.depth, p.sample,
                           p.seed, p.d_min, p.o, p.d, p.tp, p.rad, p.so,
                           p.sd, p.smax, p.pend, p.out, p.tstash,
                           p.prev_spec, p.cont_after_shadow,
                           first >= 0 ? p.pix : nullptr, reg_e, reg_s};
  for (const void* ptr : written) {
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorInvalidValue);
  }
  LaneInit q;
  q.first = first;
  q.pix = const_cast<long long*>(p.pix);
  q.reg_e = reg_e;
  q.reg_s = reg_s;
  q.regs = regs;
  q.rows = rows;
  int sms = 0, per_sm = 0, grid = 0;
  const int e = plan(&sms, &per_sm, &grid);
  if (e != 0) return e;
  // At least one block: the totals and rows are set for an empty wave too.
  const long long tiles = (n + kTile - 1) / kTile;
  const unsigned blocks = static_cast<unsigned>(
      tiles < 1 ? 1 : (tiles < grid ? tiles : static_cast<long long>(grid)));
  lane_init_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, q);
  return static_cast<int>(cudaGetLastError());
}

// The persistent engine's lane set-up for Hopper (sm_90a): one thread a
// lane writes that lane's fresh wave state, in one launch a wave.
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
//   sample offset (core/rng.py sample_seed).  Thread 0 of block 0 also
//   sets the wave's int64 totals (ops/service.py TOTALS) to [n, 0, 0, 0]
//   and its rows to 0, so the host copies nothing to the card.
//
// What bounds it on this card.  Bytes written: the state's fields, 202 B
// a lane with the texture stash, plus 16 B a skip register (48 B at the
// main path's 3), ~240 MB for 960,000 lanes, 0.072 ms at 3.35 TB/s.  Its
// arithmetic is a few double sqrt, cos and sin calls a lane, far below
// that at the card's FP64 rate.
//
// What the design does about it.  Nothing beyond one thread a lane with
// consecutive threads on consecutive lanes, so every field's stores
// coalesce (the [n, 3] vectors as three strided 4-byte stores a thread,
// which a warp's 32 threads turn into whole lines); a grid-stride loop
// covers a wave wider than the grid.  No shared memory, no atomics.
// Launched on the caller's stream; allocates nothing.

#include "service_device.cuh"

namespace trt_service {

constexpr unsigned kMaxGrid = 65535u;

struct LaneInit {
  long long first;  // pixel of lane 0 for a contiguous range, -1: read pix
  long long* pix;   // written for a range, read otherwise
  long long* reg_e;
  long long* reg_s;
  int regs;
  long long* rows;
};

__global__ void __launch_bounds__(kThreads)
    lane_init_kernel(const Params p, const LaneInit q) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.totals[kPathRays] = static_cast<unsigned long long>(p.n);
    p.totals[kShadowRays] = 0ull;
    p.totals[kLive] = 0ull;
    p.totals[kLive + 1] = 0ull;
    *q.rows = 0;
  }
  const unsigned seed = static_cast<unsigned>(p.i[kSeedBase]) +
                        static_cast<unsigned>(p.i[kSampleOffset]);
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  for (long long i =
           static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < p.n; i += stride) {
    long long pix;
    if (q.first >= 0) {
      pix = q.first + i;
      q.pix[i] = pix;
    } else {
      pix = q.pix[i];
    }
    V3 r_o, r_d;
    camera_ray(p, pix, seed, &r_o, &r_d);
    p.mode[i] = kTraverse;
    p.cur[i] = 0;
    p.hit_id[i] = -1;
    p.depth[i] = 0;
    p.sample[i] = 0;
    p.seed[i] = static_cast<long long>(seed);
    p.d_min[i] = kMissT;
    store3(p.o, i, r_o);
    store3(p.d, i, r_d);
    store3(p.tp, i, v3(1.0f, 1.0f, 1.0f));
    store3(p.rad, i, zero);
    store3(p.so, i, zero);
    store3(p.sd, i, zero);
    p.smax[i] = 0.0f;
    store3(p.pend, i, zero);
    store3(p.out, i, zero);
    if (p.tstash != nullptr) {
      for (int c = 0; c < 10; ++c) p.tstash[10 * i + c] = 0.0f;
    }
    p.prev_spec[i] = 1;
    p.cont_after_shadow[i] = 0;
    for (int c = 0; c < q.regs; ++c) {
      q.reg_e[q.regs * i + c] = -1;
      q.reg_s[q.regs * i + c] = -1;
    }
  }
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

// Fresh state for n lanes on `stream`.  floats / ints / ptrs are the
// service kernel's (ops/service.py ServiceParams and state_pointers: the
// unified table, the light rows, the texture metas, the state fields,
// the totals); reg_e / reg_s are the skip registers, int64 [n, regs]
// (null when regs is 0); first >= 0 writes pix = first + lane, -1 reads
// the state's pix; rows is the wave's int64 row count.  Launches for
// n == 0 too, to set the totals and rows.  Returns the CUDA
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
  LaneInit q;
  q.first = first;
  q.pix = const_cast<long long*>(p.pix);
  q.reg_e = reg_e;
  q.reg_s = reg_s;
  q.regs = regs;
  q.rows = rows;
  // At least one block: the totals and rows are set for an empty wave too.
  const long long blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  const unsigned grid = static_cast<unsigned>(
      blocks < static_cast<long long>(kMaxGrid) ? blocks : kMaxGrid);
  lane_init_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, q);
  return static_cast<int>(cudaGetLastError());
}

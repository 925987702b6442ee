// Quad-row BVH walk for Hopper (sm_90a): persistent blocks run every
// walking lane's whole walk in one launch.
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
// are left alone.  Per fetched row: a leaf row tests its K triangles, an
// internal row its four child boxes in the octant's
// front-to-back order; the first hit child is entered, later siblings that
// were missed go into the skip-register file, and the file redirects the
// walk past an entry when the thread order would enter it.  The registers
// live in the thread.
//
// Leaf slots come in the two formats of accel/bvh.py leaf_slot_rows, a
// template parameter of the walk: Baldwin-Weber (n, v0, bu, bv), 12
// floats a slot (the default), or Moller-Trumbore (v0, e1, e2), 9 floats
// a slot ("mt": more operations a slot over fewer bytes).  Both tests
// keep the tensor code's operation order, and an all-zero pad slot
// misses by the parallel guard in both.
//
// What bounds it.  A walk needs a row before it knows the next one, the
// lanes of a warp read 32 different rows (the quad rows, 2.2 MB on the
// main path, stay in L2), and walks differ in length.  The design answers
// each of these:
//   - Rows: the kernel walks the walk-order copy of the quad rows
//     (accel/bvh.py walk_order_table), 16-byte rows in breadth-first
//     order, and loads a row with 16-byte loads, only the columns its kind
//     needs: floats 0-39 in one batch of ten (all of an internal row, and
//     a leaf row's header and first two Baldwin-Weber or three
//     Moller-Trumbore triangles), then four loads per further
//     Baldwin-Weber triangle or nine per further Moller-Trumbore one.
//   - Top of the tree: every walk starts at the root, and most fetches hit
//     the top levels.  Each block first copies the top levels of the copy
//     into shared memory (whole levels, as many as fit beside the blocks
//     its registers let an SM hold; see plan_walk), and a fetch of such
//     a row reads shared memory, about 2.8x cheaper than L2 on this card
//     (scripts/microbench_torch_fetch.py).  Rows are staged an odd number
//     of 16-byte units apart, so rows in a quarter-warp's load spread over
//     the banks.
//   - Threads: a thread whose walk has ended would idle until its warp's
//     longest walk ends.  Blocks are persistent (as many as the card holds
//     at once, so each pays the copy once) and take lanes from a global
//     counter: when kRefillIdle or more threads of a warp are idle (or
//     all are), the warp claims that many lanes with one atomicAdd (ballot
//     + popc), and each idle thread takes one (Aila and Laine,
//     "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009:
//     persistent threads that replace finished rays).  A lane outside
//     TRAVERSE and SHADOW costs its thread one mode read.
// Measured on an H100 (PERF.md, scripts/microbench_torch_walk.py), what
// is left is the instructions a row costs a warp: staging the top rows
// moves the time by no more than its noise, while one-instruction NaN
// min/max (below) cut it by a sixth and the refill threshold, which sets
// how full a warp runs, moves shadow walks by a quarter.
// The kernel counts the rows it fetches (a block reduce, then one 64-bit
// atomic add, which is free of order), which gives the bound it is
// measured against.
//
// The launch's plan (staged rows, shared memory, grid) depends only on
// the card, the kernel and the table, so trt_quad_walk_plan works it out
// once and the caller keeps it; trt_quad_walk_launch only launches.
// Launched on the caller's stream; allocates nothing.
//
// The walk's device code (the tests, the skip registers, Walk, the lane
// claims of walk_lanes, the staging and the plan) is in
// quad_walk_device.cuh, which the wave kernel (wave_advance.cu) shares.

#include "quad_walk_device.cuh"

namespace trt {

template <int R, int F>
__global__ void __launch_bounds__(kThreads, 2)
    quad_walk_kernel(const Params p) {
  stage_rows(p);
  const Rows rows{p.table, p.width4, p.stride4, p.staged};

  unsigned long long fetched =
      walk_lanes<R, F>(p, rows, p.next_lane, nullptr, p.n);
  const int lane_in_warp = threadIdx.x & 31;

  // Rows fetched: warp shuffle, one slot per warp, one atomic per block.
  __shared__ unsigned long long warp_rows[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fetched += __shfl_down_sync(kFull, fetched, off);
  }
  if (lane_in_warp == 0) warp_rows[threadIdx.x >> 5] = fetched;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < kWarps; ++i) total += warp_rows[i];
    if (total) atomicAdd(p.rows_out, total);
  }
}

template <int R, int F>
int plan_walk(int sentinel, int stride4, const long long* levels,
              int n_levels, int* plan) {
  return plan_staged(quad_walk_kernel<R, F>, sentinel, stride4, levels,
                     n_levels, plan);
}

}  // namespace trt

// The launch plan for a table of `sentinel` quad rows of `width` floats
// whose top tree levels hold levels[0..n_levels) rows, for the kernel
// with `regs` skip registers and leaf slot format `fmt` (0 Baldwin-Weber,
// 1 Moller-Trumbore) on the current device.  plan[0..5) receives
// the rows to stage, shared bytes per block, the grid that fills the
// card, blocks per SM and threads per block.  Returns a CUDA error (0 =
// planned), 1 (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int trt_quad_walk_plan(long long sentinel, int width, int regs,
                                  int fmt, const long long* levels,
                                  int n_levels, int* plan) {
  if (sentinel < 1 || sentinel > 0x7fffffffLL || width % 4 != 0 ||
      width < 4 * trt::kHeadChunks || n_levels < 0 ||
      (fmt != trt::kFmtBW && fmt != trt::kFmtMT)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int s = static_cast<int>(sentinel);
  const int stride4 = trt::staged_stride4(width);
  switch (regs * 2 + fmt) {
    case 0 * 2 + trt::kFmtBW:
      return trt::plan_walk<0, trt::kFmtBW>(s, stride4, levels, n_levels,
                                            plan);
    case 0 * 2 + trt::kFmtMT:
      return trt::plan_walk<0, trt::kFmtMT>(s, stride4, levels, n_levels,
                                            plan);
    case 3 * 2 + trt::kFmtBW:
      return trt::plan_walk<3, trt::kFmtBW>(s, stride4, levels, n_levels,
                                            plan);
    case 3 * 2 + trt::kFmtMT:
      return trt::plan_walk<3, trt::kFmtMT>(s, stride4, levels, n_levels,
                                            plan);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// table [sentinel, width] float32, 16-byte aligned, width a multiple of 4:
// quad rows in walk order (accel/bvh.py walk_order_table) with k
// triangles of format `fmt` per leaf, its first `staged` rows staged in
// shared memory by
// each of `grid` blocks (from trt_quad_walk_plan).  n lanes: mode, cur,
// hit_id (int64), d_min [n] and rad [n, 3] (float32) are read and
// written; o, d, so, sd, pend [n, 3], smax [n] (float32) and
// cont_after_shadow [n] (bool bytes) are read.  counters: two int64,
// zero at launch: [0] counts claimed lanes, [1] is incremented by the
// rows fetched.  Returns the CUDA error of the launch (0 = launched), 1
// (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int trt_quad_walk_launch(
    const float* table, long long sentinel, int width, int k, int regs,
    int fmt, int passes, int staged, int grid, long long n,
    long long* mode, long long* cur, long long* hit_id, float* d_min,
    float* rad, const float* o, const float* d, const float* so,
    const float* sd, const float* smax, const float* pend,
    const unsigned char* cont_after_shadow, long long* counters,
    void* stream) {
  if (n <= 0) return 0;
  if (!trt::walk_args_ok(table, sentinel, width, k, fmt) || passes < 1 ||
      staged < 0 || staged > sentinel || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  trt::Params p;
  p.table = reinterpret_cast<const float4*>(table);
  p.width4 = width / 4;
  p.stride4 = trt::staged_stride4(width);
  p.staged = staged;
  p.sentinel = static_cast<int>(sentinel);
  p.k = k;
  p.passes = passes;
  p.n = n;
  p.mode_io = mode;
  p.cur_io = cur;
  p.hit_id_io = hit_id;
  p.d_min_io = d_min;
  p.rad_io = rad;
  p.o = o;
  p.d = d;
  p.so = so;
  p.sd = sd;
  p.smax = smax;
  p.pend = pend;
  p.cont_after_shadow = cont_after_shadow;
  p.next_lane = reinterpret_cast<unsigned long long*>(counters);
  p.rows_out = reinterpret_cast<unsigned long long*>(counters) + 1;
  const size_t smem = trt::staged_bytes(staged, p.stride4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (regs * 2 + fmt) {
    case 0 * 2 + trt::kFmtBW:
      trt::quad_walk_kernel<0, trt::kFmtBW><<<grid, trt::kThreads, smem,
                                               st>>>(p);
      break;
    case 0 * 2 + trt::kFmtMT:
      trt::quad_walk_kernel<0, trt::kFmtMT><<<grid, trt::kThreads, smem,
                                               st>>>(p);
      break;
    case 3 * 2 + trt::kFmtBW:
      trt::quad_walk_kernel<3, trt::kFmtBW><<<grid, trt::kThreads, smem,
                                               st>>>(p);
      break;
    case 3 * 2 + trt::kFmtMT:
      trt::quad_walk_kernel<3, trt::kFmtMT><<<grid, trt::kThreads, smem,
                                               st>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

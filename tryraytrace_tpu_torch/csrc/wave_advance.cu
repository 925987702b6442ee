// The persistent engine's wave loop for Hopper (sm_90a): one launch runs
// every lane of a wave through its rounds, each round every lane's walk
// to its end and then every lane's one service, until no lane is live or
// the launch's budget of rounds is spent.
//
// What it replaces.  On the TPU a frame is one jax.lax.while_loop on the
// device, its stop condition on the device too
// (tryraytrace_tpu/engine/persistent.py:623,635; the progressive
// engine's run, tryraytrace_tpu/engine/progressive.py:248): the loop
// body (_step_quad, the walk half and the service half) repeats until
// every lane is DONE or the iteration budget is spent.  In the port the
// round loop (engine/persistent.py Wave.advance on the CPU, and the
// two-kernel loop of quad_walk.cu and service_pass.cu) runs a round as a
// walk launch over every lane and then a service launch over every lane,
// with host work and a wait for the device between rounds.  Here the
// loop itself is on the card: one launch per Wave.advance, the stop
// condition read on the device, and the host reads two numbers at its
// end (the rounds run, the lanes not DONE).
//
// Its plain version is ops/wave.py wave_advance_plain (the round loop
// over walk_plain and service_plain, no compaction), and the kernel is
// held to the two-kernel round loop bit for bit, field for field.  It
// computes nothing of its own: the walks are quad_walk_device.cuh's
// walk_lanes, the services service_device.cuh's serve, both as the two
// kernels run them, so every float is the same sequence of rounded
// operations.
//
// Rounds.  A round is every walking lane's walk to its end, a grid-wide
// barrier, then one service for every lane (a SHADEG, TEXG or REFILL
// lane is served; the others cost a mode read), a grid-wide barrier;
// then every thread reads the round's live count (lanes not DONE) and
// the loop goes on while it is not zero and the budget lasts, exactly as
// the round loop does.  A lane stops only between rounds, so its next
// walk, in this launch or the next, starts at row 0 with an empty
// skip-register file, which is the walk's precondition.  A round runs
// only if a lane is live at its start, so the rounds are the round
// loop's.
//
// What bounds it on this card.  A round of a lane reads and writes its
// state in device memory (the walk's fields, then the service's: about
// 200 bytes each way) and fetches its walk's quad rows (the top levels
// from shared memory, the rest from L2); the service adds a material or
// texture tile row and its double sqrt, cos, sin and pow.  Per the
// kernels apart (PERF.md), the walk's rows cost a warp more in
// instructions and latency than in bytes.
//
// What the design does about it.  The round is the two kernels' round
// in one launch: the walk phase is the walk kernel's loop (persistent
// threads claim lanes from a counter and refill once half a warp is
// idle, the top levels staged in shared memory once a launch), the
// service phase the service kernel's (one lane a thread, lane order),
// and the barriers between them replace two launches and a wait for the
// host.  So every warp of the card runs one phase's code at a time, on
// full warps.  Measured on the main step (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md): a first design kept each lane on one thread across its
// rounds (its walk, then its service, then its next walk, back to back);
// it was exact but took 9.8-9.9 ms, and a progressive frame of 8 rounds
// 10.4-10.6 ms against the two kernels' 5.9-7.3: a warp ran walk and
// service code side by side, its threads waiting on each other.  Rounds
// of phases took 9.1 ms and the frame 5.3-5.4 ms; listing the live lanes
// (below) 8.9 ms.  The two kernels apart take 5.85 ms a step; what is
// left is not measured apart (PERF.md §7).
//   - The lanes a round serves are listed for the next: the service
//     phase appends each lane still live to a list (one atomicAdd a
//     warp), and the next round walks and serves the list, so a late
//     round costs its live lanes, not the wave (the round loop keeps only
//     the live lanes on the host for the same reason).  The list's order
//     is the atomics', which changes nothing a lane computes.
//   - The barriers are cooperative groups' grid sync: the launch is
//     cooperative, so every block is resident (the grid is the blocks
//     the card holds at once: two of 256 threads an SM, at 126-128
//     registers; three, at 80 registers with spills, took 9.5 ms).
//   - The counts are free of order: each thread keeps int64 counts of
//     path rays (continued + camera), shadow rays and rows fetched; a
//     warp shuffle and one slot a warp reduce them, and one integer
//     atomic a block adds each.  A round's live count is the length of
//     its list, which every thread reads after the barrier.  At
//     the end block 0 writes the live count into the wave's totals as
//     the round loop leaves it (the slot of the last round's parity, the
//     other zeroed), leaves the rounds and live lanes for the host and
//     zeroes the launch's counters for the next launch.  No float
//     atomics: a lane's sums are written only by the thread that serves
//     it.
// Launched on the caller's stream; allocates nothing.

// The service writes o, d, so, sd, smax and pend between walks: the walk
// reads them with plain loads here (quad_walk_device.cuh).
#define TRT_WALK_STATE_LOAD(ptr) (*(ptr))

#include <cooperative_groups.h>

#include "quad_walk_device.cuh"
#include "service_device.cuh"

namespace trt_wave {

namespace cg = cooperative_groups;

using trt::kFull;
using trt::kThreads;
using trt::kWarps;

// The blocks an SM must hold at once (__launch_bounds__, which caps the
// registers).  A benchmark build may set it (scripts/time_torch_wave.py);
// the port builds the default.
#ifndef TRT_WAVE_MIN_BLOCKS
#define TRT_WAVE_MIN_BLOCKS 2
#endif

// The launch's int64 counters (ops/wave.py CTL), zero at launch and left
// zero by the launch but for the two results: the walk phases' lane
// claims and the rounds' live counts, which are the lengths of the lists
// of live lanes (taken in turn by the rounds), the lanes live at the
// start, then the launch's rounds and live lanes for the host.
enum Ctl {
  kClaim0 = 0, kClaim1, kLive0, kLive1, kStart, kRoundsOut, kLiveOut,
  kNumCtl
};

struct Params {
  trt::Params walk;            // next_lane unused; rows_out: rows
  trt_service::Params service;
  unsigned long long* ctl;     // Ctl
  int* lists;                  // [2, n]: the live lanes, by round parity
  long long rounds_before;     // the wave's rounds before this launch
  int max_rounds;              // the launch's budget of rounds, >= 1
};

// The sum of v over the block, added to *dst with one atomic by thread 0
// (nothing when it is 0).  Called by every thread of the block.
__device__ __forceinline__ void block_add(unsigned long long v,
                                          unsigned long long* dst) {
  __shared__ unsigned long long warp_sums[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int wi = 0; wi < kWarps; ++wi) total += warp_sums[wi];
    if (total) atomicAdd(dst, total);
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long read_l2(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

template <int R, int F>
__global__ void __launch_bounds__(kThreads, TRT_WAVE_MIN_BLOCKS)
    wave_advance_kernel(__grid_constant__ const Params wp) {
  cg::grid_group grid = cg::this_grid();
  const trt::Params& p = wp.walk;
  const trt_service::Params& sp = wp.service;
  unsigned long long* ctl = wp.ctl;
  trt::stage_rows(p);
  const trt::Rows rows{p.table, p.width4, p.stride4, p.staged};

  const int lane_in_warp = threadIdx.x & 31;
  const unsigned below = (1u << lane_in_warp) - 1u;
  // A warp's first lane in the service phase, and the stride: every
  // thread of a warp runs the same number of iterations.
  const long long warp_first =
      static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long fetched = 0, path = 0, shadow = 0, live = 0;
  const int* list = nullptr;  // the round's lanes; none: every lane
  long long count = p.n;
  int ran = 0;
  while (ran < wp.max_rounds) {
    const int k = ran & 1;
    int* next = wp.lists + static_cast<long long>(k) * p.n;
    // The round's walks, every walking lane of the round to its end.
    fetched += trt::walk_lanes<R, F>(p, rows, ctl + kClaim0 + k, list, count);
    grid.sync();
    // The other parity's counters were last used in the round before,
    // and every thread has read its live count: clear them for the next.
    if (lead) {
      ctl[kClaim0 + 1 - k] = 0;
      ctl[kLive0 + 1 - k] = 0;
    }
    // The round's services, then the lanes still live listed for the
    // next round (one atomicAdd a warp).
    unsigned long long n_start = 0;
    for (long long j0 = warp_first; j0 < count; j0 += stride) {
      const long long j = j0 + lane_in_warp;
      long long i = -1;
      bool alive = false;
      if (j < count) {
        i = list ? list[j] : j;
        if (ran == 0) n_start += sp.mode[i] != trt_service::kDone ? 1 : 0;
        int cont = 0, fire = 0;
        bool started = false;
        alive = trt_service::serve(sp, i, &cont, &fire, &started);
        path += static_cast<unsigned long long>(cont + (started ? 1 : 0));
        shadow += static_cast<unsigned long long>(fire);
      }
      const unsigned keep = __ballot_sync(kFull, alive);
      if (keep) {
        unsigned long long at = 0;
        if (lane_in_warp == 0) {
          at = atomicAdd(ctl + kLive0 + k,
                         static_cast<unsigned long long>(__popc(keep)));
        }
        at = __shfl_sync(kFull, at, 0);
        if (alive) next[at + __popc(keep & below)] = static_cast<int>(i);
      }
    }
    if (ran == 0) block_add(n_start, ctl + kStart);
    grid.sync();
    ++ran;
    live = read_l2(ctl + kLive0 + k);
    if (ran == 1 && read_l2(ctl + kStart) == 0) ran = 0;  // nothing ran
    if (live == 0) break;
    list = next;
    count = static_cast<long long>(live);
  }

  block_add(fetched, p.rows_out);
  block_add(path, sp.totals + trt_service::kPathRays);
  block_add(shadow, sp.totals + trt_service::kShadowRays);
  // Every thread has read the counters: block 0 clears them.
  grid.sync();
  if (!lead) return;
  for (int c = 0; c < kNumCtl; ++c) ctl[c] = 0;
  ctl[kRoundsOut] = static_cast<unsigned long long>(ran);
  ctl[kLiveOut] = live;
  if (ran) {
    // The round loop leaves the live count in the slot of its last
    // round's parity and zeroes the other.
    const int slot = static_cast<int>((wp.rounds_before + ran - 1) & 1);
    sp.totals[trt_service::kLive + slot] = live;
    sp.totals[trt_service::kLive + 1 - slot] = 0;
  }
}

template <int R, int F>
int plan_wave(int sentinel, int stride4, const long long* levels,
              int n_levels, int* plan) {
  return trt::plan_staged(wave_advance_kernel<R, F>, sentinel, stride4,
                          levels, n_levels, plan);
}

// One cooperative launch of the instance <R, F>.
template <int R, int F>
cudaError_t launch(const Params& wp, int grid, size_t smem,
                   cudaStream_t st) {
  void* args[] = {const_cast<Params*>(&wp)};
  auto kernel = wave_advance_kernel<R, F>;
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(kThreads), args, smem,
                                     st);
}

}  // namespace trt_wave

// The sizes of the arrays trt_wave_advance_launch reads, for the caller to
// check against its own: floats, ints, pointers, totals, counters.
extern "C" int trt_wave_layout(int* out) {
  out[0] = trt_service::kNumFloats;
  out[1] = trt_service::kNumInts;
  out[2] = trt_service::kNumPtrs;
  out[3] = trt_service::kNumTotals;
  out[4] = trt_wave::kNumCtl;
  return 0;
}

// The launch plan for a walk-order table of `sentinel` rows of `width`
// floats whose top tree levels hold levels[0..n_levels) rows, for the
// kernel with `regs` skip registers and leaf slot format `fmt` (0
// Baldwin-Weber, 1 Moller-Trumbore) on the current device: plan[0..5)
// receives the rows to stage, shared bytes per block, the grid that
// fills the card, blocks per SM and threads per block.  Returns a CUDA
// error (0 = planned), 1 (cudaErrorInvalidValue) for arguments it does
// not take.
extern "C" int trt_wave_advance_plan(long long sentinel, int width, int regs,
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
      return trt_wave::plan_wave<0, trt::kFmtBW>(s, stride4, levels,
                                                 n_levels, plan);
    case 0 * 2 + trt::kFmtMT:
      return trt_wave::plan_wave<0, trt::kFmtMT>(s, stride4, levels,
                                                 n_levels, plan);
    case 3 * 2 + trt::kFmtBW:
      return trt_wave::plan_wave<3, trt::kFmtBW>(s, stride4, levels,
                                                 n_levels, plan);
    case 3 * 2 + trt::kFmtMT:
      return trt_wave::plan_wave<3, trt::kFmtMT>(s, stride4, levels,
                                                 n_levels, plan);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Advance n lanes by up to max_rounds rounds each, on `stream`.
//   - The walk: `table` [sentinel, width] float32, the walk-order quad
//     rows (accel/bvh.py walk_order_table), 16-byte aligned, k slots of
//     format `fmt` a leaf, `regs` skip registers, `passes` redirect
//     sweeps; its first `staged` rows staged by each of `grid` blocks
//     (trt_wave_advance_plan).
//   - The service: floats, ints and ptrs as trt_service_launch takes them
//     (ops/service.py ServiceParams; the unified table, the light rows,
//     the texture metas, the state fields and the wave's four int64
//     totals).  The walk reads and writes the same state fields.
//   - The wave: its rounds before this launch, `rounds_before` (the
//     parity of the totals' live slots); `ctl` [7] int64, zero at launch
//     but for the last two (ops/wave.py CTL), which receive the rounds
//     run and the lanes not DONE after the launch; `lists` [2, n] int32,
//     scratch for the lists of live lanes; `rows` [1] int64, to which the
//     rows the walks fetched are added.  The path rays (walks
//     continued + camera rays) and shadow rays are added to the totals,
//     and the live count replaces their live slots as the round loop
//     leaves them.
// The state is written in place.  Returns the CUDA error of the launch (0
// = launched), 1 (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int trt_wave_advance_launch(
    const float* table, long long sentinel, int width, int k, int regs,
    int fmt, int passes, int staged, int grid, const float* floats,
    const long long* ints, void* const* ptrs, long long n, int max_rounds,
    long long rounds_before, long long* ctl, int* lists, long long* rows,
    void* stream) {
  if (n <= 0) return 0;
  trt_wave::Params wp;
  if (!trt::walk_args_ok(table, sentinel, width, k, fmt) || passes < 1 ||
      staged < 0 || staged > sentinel || grid < 1 || max_rounds < 1 ||
      n > 0x7fffffffLL || rounds_before < 0 || ctl == nullptr ||
      lists == nullptr || rows == nullptr ||
      !trt_service::unpack_params(floats, ints, ptrs, n, 0, &wp.service)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using namespace trt_service;
  trt::Params& p = wp.walk;
  p.table = reinterpret_cast<const float4*>(table);
  p.width4 = width / 4;
  p.stride4 = trt::staged_stride4(width);
  p.staged = staged;
  p.sentinel = static_cast<int>(sentinel);
  p.k = k;
  p.passes = passes;
  p.n = n;
  p.mode_io = static_cast<long long*>(ptrs[kMode]);
  p.cur_io = static_cast<long long*>(ptrs[kCur]);
  p.hit_id_io = static_cast<long long*>(ptrs[kHitId]);
  p.d_min_io = static_cast<float*>(ptrs[kDMin]);
  p.rad_io = static_cast<float*>(ptrs[kRad]);
  p.o = static_cast<const float*>(ptrs[kO]);
  p.d = static_cast<const float*>(ptrs[kD]);
  p.so = static_cast<const float*>(ptrs[kSo]);
  p.sd = static_cast<const float*>(ptrs[kSd]);
  p.smax = static_cast<const float*>(ptrs[kSmax]);
  p.pend = static_cast<const float*>(ptrs[kPend]);
  p.cont_after_shadow =
      static_cast<const unsigned char*>(ptrs[kContAfterShadow]);
  wp.ctl = reinterpret_cast<unsigned long long*>(ctl);
  wp.lists = lists;
  p.next_lane = nullptr;
  p.rows_out = reinterpret_cast<unsigned long long*>(rows);
  wp.rounds_before = rounds_before;
  wp.max_rounds = max_rounds;
  const size_t smem = trt::staged_bytes(staged, p.stride4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (regs * 2 + fmt) {
    case 0 * 2 + trt::kFmtBW:
      e = trt_wave::launch<0, trt::kFmtBW>(wp, grid, smem, st);
      break;
    case 0 * 2 + trt::kFmtMT:
      e = trt_wave::launch<0, trt::kFmtMT>(wp, grid, smem, st);
      break;
    case 3 * 2 + trt::kFmtBW:
      e = trt_wave::launch<3, trt::kFmtBW>(wp, grid, smem, st);
      break;
    case 3 * 2 + trt::kFmtMT:
      e = trt_wave::launch<3, trt::kFmtMT>(wp, grid, smem, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

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
// Walk (through walk_lanes in the dense rounds), the services
// service_device.cuh's serve, both as the two kernels run them, so every
// float is the same sequence of rounded operations.
//
// Rounds.  A round is every walking lane's walk to its end, a grid-wide
// barrier, then one service for every lane (a SHADEG, TEXG or REFILL
// lane is served; the others cost a mode read), a grid-wide barrier;
// then every thread reads the round's live count (lanes not DONE) and
// the loop goes on while it is not zero and the budget lasts, exactly as
// the round loop does (until the sparse tail, below).  A lane stops only
// between rounds, so its next walk, in this launch or the next, starts
// at row 0 with an empty skip-register file, which is the walk's
// precondition.  A round runs only if a lane is live at its start, so
// the rounds are the round loop's.
//
// What bounds it on this card.  A round of a lane reads and writes its
// state in device memory (the walk's fields, then the service's: about
// 200 bytes each way) and fetches its walk's quad rows (the top levels
// from shared memory, the rest from L2); the service adds a material or
// texture tile row and its double sqrt, cos, sin and pow.  On the main
// step (1200x800, 39 rounds; PERF.md, chip_smoke.py [wave]): the bytes
// (every lane's state once each way, the rows once) bound it at
// ~0.12 ms; the rounds' latency at ~0.59 ms (each round ends on its
// longest walk, one dependent row fetch a step, ~235 ns for one warp:
// the sum over the rounds of the longest walks); neither is near the
// ~7 ms it takes.  What sets that is the lanes' work through warps
// that wait on dependent fetches: the first ~10 rounds carry nearly
// every lane and take most of the time, at 16 warps an SM.
//
// What the design does about it.
//   - Dense rounds are the two kernels' rounds in one launch: the walk
//     phase is the walk kernel's loop (persistent threads claim lanes
//     from a counter and refill once 24 of a warp's threads are idle,
//     the top levels staged in shared memory once a launch), the
//     service phase the service kernel's (one lane a thread, lane
//     order), and grid-wide barriers between them replace two launches
//     and a wait for the host.  So every warp runs one phase's code at a
//     time, on full warps: a design that kept a lane on one thread
//     across its rounds ran walk and service code side by side in a warp
//     and took 1.1-2.3x as long (PERF.md).
//   - Two blocks of 256 an SM (~128 registers), the phases inlined into
//     the round loop.  Compiled apart (__noinline__) they fit 80
//     registers and three blocks, but every parameter read becomes a load
//     and the calls spill: the service phase ran at half speed.  Inlined
//     at three blocks (TRT_WAVE_MIN_BLOCKS=3) the kernel spills ~480 B.
//     Both were slower on the main step than two blocks (PERF.md).
//   - The lanes a round serves are listed for the next: the service
//     phase appends each lane still live to a list (one atomicAdd a
//     warp), and the next round walks and serves the list, so a late
//     round costs its live lanes, not the wave.  The list's order is the
//     atomics', which changes nothing a lane computes.
//   - The sparse tail has no grid-wide barrier.  A late dense round
//     costs its longest walk, its longest service and two grid syncs,
//     however few its lanes.  So once a round leaves at most
//     TRT_WAVE_TAIL_WARP_LANES live lanes a warp of the grid, the lanes
//     left on the list are shared out among the grid's warps,
//     consecutive entries, warps numbered across the SMs first; each
//     warp runs its own rounds over its lanes, 32 at a time: every one
//     walks to its end (the same Walk start and step), __syncwarp, every
//     one is served (the same serve), until each is DONE or has run the
//     launch's remaining budget.  A lane's late rounds then cost its own
//     chain and its warp's, not the grid's longest walk and two barriers
//     a round; and a warp still runs one phase's code at a time.  The
//     launch's rounds are the dense rounds plus the most tail rounds of
//     any warp (an atomicMax): a lane runs a round only while it is
//     live, so these are the round loop's rounds.  32 lanes a warp
//     (round 13 of the main step's 39) was the fastest of 16, 32, 64
//     and 128.
//   - The barriers are cooperative groups' grid sync: the launch is
//     cooperative, so every block is resident (the grid is the blocks
//     the card holds at once).
//   - The counts are free of order: each thread keeps int64 counts of
//     path rays (continued + camera), shadow rays and rows fetched; a
//     warp shuffle and one slot a warp reduce them, and one integer
//     atomic a block adds each.  A dense round's live count is the length
//     of its list, which every thread reads after the barrier; the
//     tail's lanes not DONE are counted with one atomic a warp.  At the
//     end block 0 writes the live count into the wave's totals as the
//     round loop leaves it (the slot of the last round's parity, the
//     other zeroed), leaves the rounds and live lanes for the host and
//     zeroes the launch's counters for the next launch.  No float
//     atomics: a lane's sums are written only by the thread that serves
//     it.
//   - No asynchronous copy and no tensor core: the staging is a copy of
//     at most ~80 KB a block once a launch, which a TMA bulk copy would
//     not shorten enough to repay its code, and there is no matrix
//     product; every row fetch depends on the one before.
// Launched on the caller's stream; allocates nothing.

// The service writes o, d, so, sd, smax and pend between walks: the walk
// reads them with plain loads here (quad_walk_device.cuh).
#define TRT_WALK_STATE_LOAD(ptr) (*(ptr))
// The walk phase's warps claim lanes once 24 of their threads are idle:
// in this kernel, at two blocks an SM, the fastest of 4, 8, 16, 24 and
// 32 on the main step (PERF.md; the walk kernel alone keeps 16).  A
// benchmark build may set it.
#ifndef TRT_WALK_REFILL_IDLE
#define TRT_WALK_REFILL_IDLE 24
#endif

#include <cooperative_groups.h>

#include "quad_walk_device.cuh"
#include "service_device.cuh"

namespace trt_wave {

namespace cg = cooperative_groups;

using trt::kFull;
using trt::kThreads;
using trt::kWarps;

// The blocks an SM must hold at once (__launch_bounds__, which caps the
// registers) and the tail's threshold (the tail starts once a round
// leaves at most TRT_WAVE_TAIL_WARP_LANES live lanes a warp of the grid;
// 0: no tail).  A benchmark build may set either
// (scripts/time_torch_wave.py); the port builds the defaults.
#ifndef TRT_WAVE_MIN_BLOCKS
#define TRT_WAVE_MIN_BLOCKS 2
#endif
#ifndef TRT_WAVE_TAIL_WARP_LANES
#define TRT_WAVE_TAIL_WARP_LANES 32
#endif
constexpr long long kTailWarpLanes = TRT_WAVE_TAIL_WARP_LANES;
static_assert(kTailWarpLanes >= 0, "tail threshold");

// The launch's int64 counters (ops/wave.py CTL), zero at launch and left
// zero by the launch but for the two results: the walk phases' lane
// claims and the rounds' live counts, which are the lengths of the lists
// of live lanes (taken in turn by the dense rounds), the lanes live at
// the start, the most tail rounds of a warp and the tail's lanes not
// DONE, then the launch's rounds and live lanes for the host.
enum Ctl {
  kClaim0 = 0, kClaim1, kLive0, kLive1, kStart, kTailRounds, kTailLive,
  kRoundsOut, kLiveOut, kNumCtl
};

struct Params {
  trt::Params walk;            // next_lane unused; rows_out: rows
  trt_service::Params service;
  unsigned long long* ctl;     // Ctl
  int* lists;                  // [2, n]: the live lanes, by round parity
  long long rounds_before;     // the wave's rounds before this launch
  int max_rounds;              // the launch's budget of rounds, >= 1
};

// A thread's counts: rows fetched, path rays (walks continued + camera
// rays), shadow rays, and lanes live at the start (round 0 only).
struct Counts {
  unsigned long long rows, path, shadow, start;
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

// The round clock of a benchmark build (-D TRT_WAVE_ROUND_CLOCK,
// scripts/time_torch_wave.py --rounds): thread 0 of block 0 records the
// card's %globaltimer (ns) at the start and after each grid sync, each
// dense round's live count, and the launch's dense and tail rounds;
// trt_wave_round_clock reads them back.  The port's build records nothing.
enum Clock { kClockStart = 0, kClockEnd, kClockDense, kClockTail, kClockHead };
constexpr int kClockRounds = 1024;  // dense rounds recorded, 3 slots each
#ifdef TRT_WAVE_ROUND_CLOCK
__device__ unsigned long long round_clock[kClockHead + 3 * kClockRounds];
#endif

__device__ __forceinline__ void clock_mark(bool lead, int slot,
                                           unsigned long long value) {
#ifdef TRT_WAVE_ROUND_CLOCK
  if (lead && slot < kClockHead + 3 * kClockRounds) round_clock[slot] = value;
#endif
}

__device__ __forceinline__ unsigned long long clock_now() {
#ifdef TRT_WAVE_ROUND_CLOCK
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#else
  return 0;
#endif
}

__device__ __forceinline__ unsigned long long read_l2(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// A dense round's walks: every walking lane of the round (list[j] for j <
// count; every lane without a list) to its end, lanes claimed from the
// counter of parity k.  Called by every thread.  Returns its rows.
template <int R, int F>
__device__ __forceinline__ unsigned long long walk_phase(
    const Params& wp, int k, const int* list, long long count) {
  const trt::Params& p = wp.walk;
  const trt::Rows rows{p.table, p.width4, p.stride4, p.staged};
  return trt::walk_lanes<R, F>(p, rows, wp.ctl + kClaim0 + k, list, count);
}

// A dense round's services, one lane a thread in list order, and the lanes
// still live listed for the next round in the list of parity k (one
// atomicAdd a warp).  Called by every thread; every thread of a warp runs
// the same iterations.  With `first`, also counts the lanes live at the
// start.  Returns the thread's counts.
__device__ __forceinline__ Counts serve_phase(const Params& wp, int k,
                                              bool first, const int* list,
                                              long long count) {
  const trt_service::Params& sp = wp.service;
  const int lane_in_warp = threadIdx.x & 31;
  const unsigned below = (1u << lane_in_warp) - 1u;
  int* next = wp.lists + static_cast<long long>(k) * wp.walk.n;
  Counts c{0, 0, 0, 0};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j0 = static_cast<long long>(blockIdx.x) * kThreads +
                      (threadIdx.x & ~31);
       j0 < count; j0 += stride) {
    const long long j = j0 + lane_in_warp;
    long long i = -1;
    bool alive = false;
    if (j < count) {
      i = list ? list[j] : j;
      if (first) c.start += sp.mode[i] != trt_service::kDone ? 1 : 0;
      int cont = 0, fire = 0;
      bool started = false;
      alive = trt_service::serve(sp, i, &cont, &fire, &started);
      c.path += static_cast<unsigned long long>(cont + (started ? 1 : 0));
      c.shadow += static_cast<unsigned long long>(fire);
    }
    const unsigned keep = __ballot_sync(kFull, alive);
    if (keep) {
      unsigned long long at = 0;
      if (lane_in_warp == 0) {
        at = atomicAdd(wp.ctl + kLive0 + k,
                       static_cast<unsigned long long>(__popc(keep)));
      }
      at = __shfl_sync(kFull, at, 0);
      if (alive) next[at + __popc(keep & below)] = static_cast<int>(i);
    }
  }
  return c;
}

// A tail round's walk of the thread's lane i (none: i < 0) to its end,
// with the walk kernel's device code.  Called by every thread of the warp
// together.  Returns the rows fetched.
template <int R, int F>
__device__ __forceinline__ unsigned long long walk_own(const trt::Params& p,
                                                       long long i) {
  const trt::Rows rows{p.table, p.width4, p.stride4, p.staged};
  trt::Walk<R, F> w;
  w.lane = -1;
  if (i >= 0) w.start(p, i);
  unsigned long long fetched = 0;
  while (__ballot_sync(kFull, w.lane >= 0)) {
    if (w.lane >= 0) {
      ++fetched;
      w.step(p, rows);
    }
  }
  return fetched;
}

// A tail round's service of lane i.
struct Served {
  unsigned long long path, shadow;
  bool alive;  // the lane is left not DONE
};
__device__ __forceinline__ Served serve_own(const trt_service::Params& sp,
                                            long long i) {
  int cont = 0, fire = 0;
  bool started = false;
  const bool alive = trt_service::serve(sp, i, &cont, &fire, &started);
  return Served{static_cast<unsigned long long>(cont + (started ? 1 : 0)),
                static_cast<unsigned long long>(fire), alive};
}

// The tail: the `count` lanes of `list` shared out among the grid's warps,
// at most kTailWarpLanes consecutive entries a warp, taken 32 at a time;
// each 32 run by their own rounds (walks, __syncwarp, services) until
// each is DONE or has run `budget` rounds.  Adds the most rounds and the
// lanes not DONE of each 32 to the launch's counters (one atomic a warp
// each) and the thread's counts to *c.  Called by every thread.
template <int R, int F>
__device__ __forceinline__ void run_tail(const Params& wp, const int* list,
                                         long long count, int budget,
                                         Counts* c) {
  const int lane_in_warp = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  // Warps numbered across the blocks first, so few lanes spread over SMs.
  const long long warp = static_cast<long long>(threadIdx.x >> 5) *
                             gridDim.x + blockIdx.x;
  const long long per = (count + warps - 1) / warps;
  const long long end = min(warp * per + per, count);
  for (long long base = warp * per; base < end; base += 32) {
    const long long j = base + lane_in_warp;
    long long i = j < end ? list[j] : -1;
    int own = 0;
    while (own < budget && __ballot_sync(kFull, i >= 0)) {
      c->rows += walk_own<R, F>(wp.walk, i);
      __syncwarp();
      if (i >= 0) {
        const Served s = serve_own(wp.service, i);
        c->path += s.path;
        c->shadow += s.shadow;
        if (!s.alive) i = -1;
      }
      ++own;
    }
    const unsigned left = __ballot_sync(kFull, i >= 0);
    if (lane_in_warp == 0 && own) {
      atomicMax(wp.ctl + kTailRounds, static_cast<unsigned long long>(own));
      if (left) {
        atomicAdd(wp.ctl + kTailLive,
                  static_cast<unsigned long long>(__popc(left)));
      }
    }
  }
}

template <int R, int F>
__global__ void __launch_bounds__(kThreads, TRT_WAVE_MIN_BLOCKS)
    wave_advance_kernel(__grid_constant__ const Params wp) {
  cg::grid_group grid = cg::this_grid();
  unsigned long long* ctl = wp.ctl;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  clock_mark(lead, kClockStart, clock_now());
  trt::stage_rows(wp.walk);

  Counts c{0, 0, 0, 0};
  // The round's lanes: every lane in round 0, then the list of the round
  // before, `count` long (the live lanes it left).
  int count = static_cast<int>(wp.walk.n);
  int ran = 0;
  bool tail = false;
  while (ran < wp.max_rounds) {
    const int k = ran & 1;
    const int* list =
        ran ? wp.lists + static_cast<long long>(1 - k) * wp.walk.n : nullptr;
    // The round's walks, every walking lane of the round to its end.
    c.rows += walk_phase<R, F>(wp, k, list, count);
    grid.sync();
    clock_mark(lead, kClockHead + 3 * ran, clock_now());
    // The other parity's counters were last used in the round before,
    // and every thread has read its live count: clear them for the next.
    if (lead) {
      ctl[kClaim0 + 1 - k] = 0;
      ctl[kLive0 + 1 - k] = 0;
    }
    // The round's services, then the lanes still live listed for the
    // next round.
    const Counts s = serve_phase(wp, k, ran == 0, list, count);
    c.path += s.path;
    c.shadow += s.shadow;
    if (ran == 0) block_add(s.start, ctl + kStart);
    grid.sync();
    clock_mark(lead, kClockHead + 3 * ran + 1, clock_now());
    ++ran;
    count = static_cast<int>(read_l2(ctl + kLive0 + k));
    clock_mark(lead, kClockHead + 3 * ran - 1, count);
    if (ran == 1 && read_l2(ctl + kStart) == 0) ran = 0;  // nothing ran
    if (count == 0) break;
    // Few lanes left: no more grid-wide rounds (the same test in every
    // thread, on the count every thread read).
    if (kTailWarpLanes > 0 && ran < wp.max_rounds &&
        count <= static_cast<long long>(gridDim.x) * kWarps * kTailWarpLanes) {
      tail = true;
      break;
    }
  }
  if (tail) {
    run_tail<R, F>(wp, wp.lists + static_cast<long long>((ran - 1) & 1) *
                                      wp.walk.n,
                   count, wp.max_rounds - ran, &c);
  }

  block_add(c.rows, wp.walk.rows_out);
  block_add(c.path, wp.service.totals + trt_service::kPathRays);
  block_add(c.shadow, wp.service.totals + trt_service::kShadowRays);
  // Every thread has read the counters and added its own: block 0 reads
  // the tail's and clears them.
  grid.sync();
  if (!lead) return;
  const unsigned long long more = tail ? ctl[kTailRounds] : 0;
  const unsigned long long live =
      tail ? ctl[kTailLive] : static_cast<unsigned long long>(count);
  clock_mark(lead, kClockEnd, clock_now());
  clock_mark(lead, kClockDense, static_cast<unsigned long long>(ran));
  clock_mark(lead, kClockTail, more);
  ran += static_cast<int>(more);
  for (int i = 0; i < kNumCtl; ++i) ctl[i] = 0;
  ctl[kRoundsOut] = static_cast<unsigned long long>(ran);
  ctl[kLiveOut] = live;
  if (ran) {
    // The round loop leaves the live count in the slot of its last
    // round's parity and zeroes the other.
    const int slot = static_cast<int>((wp.rounds_before + ran - 1) & 1);
    wp.service.totals[trt_service::kLive + slot] = live;
    wp.service.totals[trt_service::kLive + 1 - slot] = 0;
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
// check against its own: floats, ints, pointers, totals, counters; then
// the tail's threshold (TRT_WAVE_TAIL_WARP_LANES: the tail starts once a
// round leaves at most that many live lanes a warp of the grid; 0: no
// tail).
extern "C" int trt_wave_layout(int* out) {
  out[0] = trt_service::kNumFloats;
  out[1] = trt_service::kNumInts;
  out[2] = trt_service::kNumPtrs;
  out[3] = trt_service::kNumTotals;
  out[4] = trt_wave::kNumCtl;
  out[5] = static_cast<int>(trt_wave::kTailWarpLanes);
  return 0;
}

#ifdef TRT_WAVE_ROUND_CLOCK
// The round clock of the last launch (benchmark builds only): out[0..n)
// receives the slots of trt_wave::Clock, then each recorded dense round's
// walk end, service end (ns) and live count.  Waits for the device.
extern "C" int trt_wave_round_clock(long long* out, int n) {
  const int size = trt_wave::kClockHead + 3 * trt_wave::kClockRounds;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, trt_wave::round_clock, sizeof(long long) * (n < size ? n : size)));
}
#endif

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
//     parity of the totals' live slots); `ctl` [9] int64, zero at launch
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

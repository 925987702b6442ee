// Dependent row-fetch chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/microbench_pallas_fetch.py
// (_fetch_kernel, through onehot_fetch): `steps` times, fetch row `idx`
// of a [M, W] table, add its column 0 (widened to float32) to an
// accumulator, and advance idx = (idx + int(column 1) + 1) mod M.  On the
// TPU the fetch is one_hot(idx) @ table, which reads the whole W-wide row
// and selects it exactly, so the function is a gather chain of whole
// rows: every step here loads every column of its row, in 16-byte loads.
// The last fetched row's columns are summed in column order into
// `rowsum`, the second output.
//
// Two placements of the table, same outputs:
//   global: every row is read from device memory (each table this is
//           run on fits the card's L2, most of them its L1);
//   shared: each block first copies the table's leading `staged` rows,
//           as many as fit, into dynamic shared memory, reads those there
//           and the others from device memory.
//
// What bounds it on this card.  Every lane moves steps x row bytes
// through its SM's load path, which serves 128 bytes a clock, and each
// step's row address comes from the row before (PERF.md: the larger of
// that byte bound and 64 one-warp steps).  The first port, one thread
// reading its own row, was bound by neither: a warp's 16-byte load from
// 32 lanes' rows touches 32 lines where its 512 bytes need 4, so the L1
// spent 8x the bytes' cycles.  The design (PERF.md, each part measured
// in turns against that kernel):
//   - A row is read by C threads at once, C its 16-byte chunks (a
//     template parameter, 1 to 32): load `it` of thread `sub` of a group
//     of C lanes is chunk (sub - it) mod C of the row of lane group + it,
//     so one load instruction covers 32 / C whole rows (half a warp a
//     256-byte row) and each lane reads its own chunk 0 itself.  The rows'
//     indices go round the group by __shfl_sync.  A thread's loads of a
//     step are issued in batches of 16, before any of them is used.
//   - No float chain on the step's path: the loaded words are folded by
//     XOR, and the fold is stored only under a condition no launch meets,
//     which the compiler cannot know, so no load can be dropped.  The
//     column-order sum is taken of the last row only, which each lane
//     reads alone.
//   - The modulo by M takes no division (FloorMod).
//   - Staging: one thread asks for the leading rows with bulk
//     asynchronous copies (cp.async.bulk) that complete on an mbarrier
//     kept after the rows; blocks of 512 threads, no more than the card
//     holds at once, stride over the lanes, so an SM stages once.  When
//     every row is staged the loop reads shared memory only; otherwise a
//     row's chunk is one generic load, which reaches shared or device
//     memory by its address (a predicated pair of loads, one of each,
//     took twice the time).
//
// Launched on the caller's stream; allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace trt_fetch {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 16;         // 16-byte loads a thread issues at once
constexpr int kBarrierBytes = 8;   // the staging copy's mbarrier
constexpr int kThreads = 512;
constexpr int kCopyPiece = 32768;  // bytes one bulk copy moves

struct Chain {
  const uint4* table;
  const int* idx0;
  float* acc;
  float* rowsum;
  int n, m, steps, staged;
  uint32_t magic;
  int shift;
};

// Columns 0 and 1 of a row, widened to float32, from its first 16 bytes;
// a bfloat16 is the high half of the float32 of the same value.
template <bool BF16>
__device__ __forceinline__ float col0(const uint4& v) {
  return BF16 ? __uint_as_float(v.x << 16) : __uint_as_float(v.x);
}
template <bool BF16>
__device__ __forceinline__ float col1(const uint4& v) {
  return BF16 ? __uint_as_float(v.x & 0xffff0000u) : __uint_as_float(v.y);
}

// `sum` plus the chunk's columns, one at a time in column order.
template <bool BF16>
__device__ __forceinline__ float add_chunk(float sum, const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (BF16) {
      sum = sum + __uint_as_float(w[i] << 16);
      sum = sum + __uint_as_float(w[i] & 0xffff0000u);
    } else {
      sum = sum + __uint_as_float(w[i]);
    }
  }
  return sum;
}

// floor(x mod m) for every int32 x and 1 <= m < 2^31 without a division
// (Granlund and Montgomery, PLDI 1994, fig. 4.1): with l = ceil(log2 m)
// and magic = floor(2^32 (2^l - m) / m) + 1 (ops/fetch.py
// mod_constants), the quotient of an unsigned u < 2^32 is
// (t + ((u - t) >> min(l, 1))) >> max(l - 1, 0), t = umulhi(magic, u).
// A signed x is u = x + 2^31, so x mod m = (u mod m - 2^31 mod m) mod m.
struct FloorMod {
  uint32_t m, magic, off;
  int sh1, sh2;
  __device__ FloorMod(int m_, uint32_t magic_, int shift)
      : m(static_cast<uint32_t>(m_)), magic(magic_), off(0),
        sh1(shift < 1 ? shift : 1), sh2(shift > 1 ? shift - 1 : 0) {
    off = umod(0x80000000u);
  }
  __device__ __forceinline__ uint32_t umod(uint32_t u) const {
    const uint32_t t = __umulhi(magic, u);
    const uint32_t q = (t + ((u - t) >> sh1)) >> sh2;
    return u - q * m;
  }
  __device__ __forceinline__ int operator()(int x) const {
    const uint32_t a = umod(static_cast<uint32_t>(x) ^ 0x80000000u);
    return static_cast<int>(a >= off ? a - off : a + (m - off));
  }
};

// idx + int(column 1) + 1, wrapping as int32, reduced mod m.
__device__ __forceinline__ int next_index(const FloorMod& mod, int idx,
                                          float c1) {
  return mod(static_cast<int>(static_cast<uint32_t>(idx) +
                              static_cast<uint32_t>(static_cast<int>(c1)) +
                              1u));
}

// Where the 16-byte chunk k of row r lies: device memory (SHARED false),
// shared memory (ALL: every row is staged), or either by its address.
template <bool SHARED, bool ALL, int C>
struct Rows {
  static constexpr int kChunks = C;
  const uint4* g;  // device memory: row r at g + r * C
  const uint4* s;  // shared memory: rows [0, staged)
  int staged;
  __device__ __forceinline__ uint4 load(int r, int k) const {
    if (!SHARED) return __ldg(g + static_cast<size_t>(r) * C + k);
    if (ALL) return s[r * C + k];
    const uint4* p =
        r < staged ? s + r * C + k : g + static_cast<size_t>(r) * C + k;
    uint4 v;
    asm("ld.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  }
};

__host__ __device__ constexpr int batch(int c) {
  return c < kBatch ? c : kBatch;
}

// The last step: the lane reads its own row alone, every chunk in
// batches, adds its column 0 to `acc` and returns the column-order sum
// of its columns.
template <bool BF16, class R>
__device__ __forceinline__ float last_step(const R& rows, int idx,
                                           float& acc) {
  constexpr int C = R::kChunks;
  constexpr int B = batch(C);
  float sum = 0.0f;
#pragma unroll
  for (int b = 0; b < C; b += B) {
    uint4 v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) v[j] = rows.load(idx, b + j);
    if (b == 0) acc = acc + col0<BF16>(v[0]);
#pragma unroll
    for (int j = 0; j < B; ++j) sum = add_chunk<BF16>(sum, v[j]);
  }
  return sum;
}

// A step that is not the last: the warp reads its 32 lanes' rows
// together, C threads a row, and folds every word into `fold`; each lane
// adds its own column 0 and takes its next index from its own chunk 0.
template <bool BF16, class R>
__device__ __forceinline__ void warp_step(const R& rows, const FloorMod& mod,
                                          int lane, int& idx, float& acc,
                                          uint32_t& fold) {
  constexpr int C = R::kChunks;
  constexpr int B = batch(C);
  const int sub = lane & (C - 1);
  const int group = lane - sub;
  uint4 first = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int b = 0; b < C; b += B) {
    uint4 v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int it = b + j;
      const int r = C == 1 ? idx : __shfl_sync(kFull, idx, group + it);
      v[j] = rows.load(r, (sub - it) & (C - 1));
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (b + j == sub) first = v[j];
      fold ^= v[j].x ^ v[j].y ^ v[j].z ^ v[j].w;
    }
  }
  acc = acc + col0<BF16>(first);
  idx = next_index(mod, idx, col1<BF16>(first));
}

// Copies the table's leading `rows` rows of C chunks into shared memory
// at `dst`: one thread asks for them with bulk asynchronous copies that
// complete on an mbarrier placed right after them; every thread waits
// for it.
template <int C>
__device__ void stage(uint4* dst, const uint4* src, int rows) {
  const int bytes = rows * C * 16;
  uint64_t* bar = reinterpret_cast<uint64_t*>(dst + rows * C);
  const uint32_t bar_a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  const uint32_t dst_a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a),
        "r"(bytes)
        : "memory");
    const char* from = reinterpret_cast<const char*>(src);
    for (int off = 0; off < bytes; off += kCopyPiece) {
      const int size = bytes - off < kCopyPiece ? bytes - off : kCopyPiece;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(dst_a + off),
          "l"(reinterpret_cast<uint64_t>(from + off)), "r"(size), "r"(bar_a)
          : "memory");
    }
  }
  __syncthreads();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar_a)
        : "memory");
  }
}

// Every lane's chain: whole warps stride over the lanes; a warp's lanes
// past n walk row 0 and write nothing.
template <bool BF16, class R>
__device__ __forceinline__ void run_lanes(const Chain& ch, const R& rows) {
  const FloorMod mod(ch.m, ch.magic, ch.shift);
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < ch.n; base += stride) {
    const int i = base + lane;
    int idx = i < ch.n ? mod(ch.idx0[i]) : 0;
    float acc = 0.0f, rowsum = 0.0f;
    uint32_t fold = 0;
    if (ch.steps > 0) {
      for (int s = 1; s < ch.steps; ++s) {
        warp_step<BF16>(rows, mod, lane, idx, acc, fold);
      }
      rowsum = last_step<BF16>(rows, idx, acc);
    }
    if (i < ch.n) {
      ch.acc[i] = acc;
      ch.rowsum[i] = rowsum;
      // Never true (the wrapper refuses m < 1), but the compiler cannot
      // know it: the fold of every earlier row has a use, so no load of
      // it can be dropped.
      if (ch.m < 1) ch.rowsum[i] = __uint_as_float(fold);
    }
  }
}

template <bool BF16, bool SHARED, int C>
__global__ void __launch_bounds__(kThreads)
    fetch_chain_kernel(const Chain ch) {
  extern __shared__ uint4 staged_rows[];
  if (SHARED) stage<C>(staged_rows, ch.table, ch.staged);
  if (SHARED && ch.staged == ch.m) {
    run_lanes<BF16>(ch, Rows<SHARED, true, C>{ch.table, staged_rows,
                                              ch.staged});
  } else {
    run_lanes<BF16>(ch, Rows<SHARED, false, C>{ch.table, staged_rows,
                                               ch.staged});
  }
}

// Blocks of kThreads, no more than the card holds at once (each one
// stages once and strides over the lanes).  That grid, and the kernel's
// shared-memory limit, are worked out once for each device and staged
// size: the last pair is kept.
template <bool BF16, bool SHARED, int C>
int launch(const Chain& ch, cudaStream_t stream) {
  auto kernel = fetch_chain_kernel<BF16, SHARED, C>;
  static int plan_dev = -1, plan_grid = 0;
  static size_t plan_smem = 0;
  const size_t smem =
      SHARED ? static_cast<size_t>(ch.staged) * C * 16 + kBarrierBytes : 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev != plan_dev || smem != plan_smem)) {
    int sms = 0, per_sm = 0;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    }
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    }
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) {
      plan_dev = dev;
      plan_smem = smem;
      plan_grid = sms * per_sm;
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  int grid = (ch.n + kThreads - 1) / kThreads;
  if (grid > plan_grid) grid = plan_grid;
  kernel<<<grid, kThreads, smem, stream>>>(ch);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, bool SHARED>
int by_chunks(int chunks, const Chain& ch, cudaStream_t stream) {
  switch (chunks) {
    case 1: return launch<BF16, SHARED, 1>(ch, stream);
    case 2: return launch<BF16, SHARED, 2>(ch, stream);
    case 4: return launch<BF16, SHARED, 4>(ch, stream);
    case 8: return launch<BF16, SHARED, 8>(ch, stream);
    case 16: return launch<BF16, SHARED, 16>(ch, stream);
    case 32: return launch<BF16, SHARED, 32>(ch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace trt_fetch

// table [m, w] of float32 (itemsize 4) or bfloat16 (itemsize 2), 16-byte
// aligned, rows of 16, 32, 64, 128, 256 or 512 bytes; idx [n] int32;
// acc, rowsum [n] float32.  staged = 0 reads every row from device
// memory; staged > 0 stages rows [0, staged) in each block's shared
// memory (staged x row bytes + 8 within a block's limit).  magic and
// shift are ops/fetch.py mod_constants(m).  Returns the CUDA error of
// the launch (0 = launched), 1 (cudaErrorInvalidValue) for arguments it
// does not take.
extern "C" int trt_fetch_chain_launch_staged(
    const void* table, const int* idx, float* acc, float* rowsum, int n,
    int m, int w, int itemsize, int steps, int staged, unsigned magic,
    int shift, void* stream) {
  if (n <= 0) return 0;
  const int row_bytes = w * itemsize;
  if ((itemsize != 2 && itemsize != 4) || m < 1 || w < 2 || steps < 0 ||
      staged < 0 || staged > m || shift < 0 || shift > 31 ||
      row_bytes % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const trt_fetch::Chain ch{static_cast<const uint4*>(table), idx, acc,
                            rowsum, n, m, steps, staged, magic, shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = row_bytes / 16;
  if (itemsize == 2) {
    return staged ? trt_fetch::by_chunks<true, true>(chunks, ch, st)
                  : trt_fetch::by_chunks<true, false>(chunks, ch, st);
  }
  return staged ? trt_fetch::by_chunks<false, true>(chunks, ch, st)
                : trt_fetch::by_chunks<false, false>(chunks, ch, st);
}

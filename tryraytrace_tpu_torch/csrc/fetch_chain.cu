// Dependent row-fetch chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/microbench_pallas_fetch.py
// (_fetch_kernel, through onehot_fetch): `steps` times, fetch row `idx`
// of a [M, W] table, add its column 0 (widened to float32) to an
// accumulator, and advance idx = (idx + int(column 1) + 1) mod M.  On the
// TPU the fetch is one_hot(idx) @ table; a one-hot product selects one
// row exactly, so the function is a gather chain and that is what this
// kernel does: one thread per lane, a scalar loop-carried index, no
// one-hot and no matrix product.
//
// A thread pays only for the columns it loads, so every step loads the
// whole row (16-byte loads) and sums its W columns in column order into
// `rowsum`; the last fetched row's sum is the second output.  The empty
// asm statement keeps each step's sum alive, so the compiler cannot
// shrink the row read of the earlier steps to columns 0 and 1.
//
// Two placements of the table, same outputs:
//   global: rows are read where they lie (every table this is run on fits
//           the card's L2);
//   shared: each block first copies the table into dynamic shared memory
//           and the chain reads it there.  Lanes of a warp read different
//           rows at the same column, and rows of 256 B or 512 B all start
//           in the same bank, so the rows are laid 16 B further apart
//           (kPadBytes): eight consecutive rows then cover all 32 banks.
//           The table fits when M * (W * itemsize + 16) <= 232,448 B.
//
// What bounds it: neither device-memory bytes (the table is read once)
// nor arithmetic, but the latency of the dependent fetch: a lane cannot
// start step s+1 before step s's row has arrived.  The card hides it with
// many lanes in flight; the kernel is the measurement of how well.
//
// Launched on the caller's stream; allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPadBytes = 16;

// The 16-byte chunk's elements widened to float32, in column order.
template <bool BF16>
struct Chunk;

template <>
struct Chunk<false> {
  static constexpr int kElems = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

template <>
struct Chunk<true> {
  static constexpr int kElems = 8;
  // A bfloat16 is the high half of the float32 of the same value.
  __device__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ int floor_mod(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;
}

template <bool BF16, bool SHARED>
__global__ void fetch_chain_kernel(const unsigned char* __restrict__ table,
                                   const int* __restrict__ idx0,
                                   float* __restrict__ acc_out,
                                   float* __restrict__ rowsum_out, int n,
                                   int m, int row_bytes, int steps) {
  extern __shared__ uint4 staged[];
  const int chunks = row_bytes / 16;
  const unsigned char* base = table;
  int stride = row_bytes;
  if (SHARED) {
    stride = row_bytes + kPadBytes;
    const uint4* src = reinterpret_cast<const uint4*>(table);
    const int total = m * chunks;
    for (int c = threadIdx.x; c < total; c += blockDim.x) {
      const int r = c / chunks;
      staged[r * (stride / 16) + (c - r * chunks)] = src[c];
    }
    __syncthreads();
    base = reinterpret_cast<const unsigned char*>(staged);
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  int idx = floor_mod(idx0[lane], m);
  float acc = 0.0f;
  float rowsum = 0.0f;
  for (int s = 0; s < steps; ++s) {
    const uint4* row = reinterpret_cast<const uint4*>(
        base + static_cast<size_t>(idx) * stride);
    float col0 = 0.0f, col1 = 0.0f;
    rowsum = 0.0f;
    for (int k = 0; k < chunks; ++k) {
      float f[Chunk<BF16>::kElems];
      Chunk<BF16>::unpack(row[k], f);
      if (k == 0) {
        col0 = f[0];
        col1 = f[1];
      }
#pragma unroll
      for (int i = 0; i < Chunk<BF16>::kElems; ++i) rowsum = rowsum + f[i];
    }
    asm volatile("" : "+f"(rowsum));
    acc = acc + col0;
    idx = floor_mod(idx + static_cast<int>(col1) + 1, m);
  }
  acc_out[lane] = acc;
  rowsum_out[lane] = rowsum;
}

template <bool BF16, bool SHARED>
int launch(const void* table, const int* idx, float* acc, float* rowsum,
           int n, int m, int row_bytes, int steps, cudaStream_t stream) {
  auto kernel = fetch_chain_kernel<BF16, SHARED>;
  const int threads = SHARED ? 512 : 256;
  size_t smem = 0;
  if (SHARED) {
    smem = static_cast<size_t>(m) * (row_bytes + kPadBytes);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const int blocks = (n + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const unsigned char*>(table), idx, acc, rowsum, n, m,
      row_bytes, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [m, w] of float32 (itemsize 4) or bfloat16 (itemsize 2), rows a
// multiple of 16 B; idx [n] int32; acc, rowsum [n] float32.  shared != 0
// stages the table in shared memory.  Returns the CUDA error of the
// launch (0 = launched), 1 (cudaErrorInvalidValue) for an itemsize it
// does not take.
extern "C" int trt_fetch_chain_launch(const void* table, const int* idx,
                                      float* acc, float* rowsum, int n, int m,
                                      int w, int itemsize, int steps,
                                      int shared, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_bytes = w * itemsize;
  if (itemsize == 2) {
    return shared ? launch<true, true>(table, idx, acc, rowsum, n, m,
                                       row_bytes, steps, st)
                  : launch<true, false>(table, idx, acc, rowsum, n, m,
                                        row_bytes, steps, st);
  }
  if (itemsize == 4) {
    return shared ? launch<false, true>(table, idx, acc, rowsum, n, m,
                                        row_bytes, steps, st)
                  : launch<false, false>(table, idx, acc, rowsum, n, m,
                                         row_bytes, steps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Progressive-accumulator tonemap for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tryraytrace_tpu/ops/pallas_tonemap.py
// (_tonemap_kernel): for every float of the radiance sum accum [N, 3],
//     out = trunc(clamp(accum * inv_spp, 0, 1) ^ gamma * 255 + 0.5)
// as uint8 -- the reference's toInt (common.h:126-128).
//
// It reads 12 B and writes 3 B per pixel, and exists so that only the
// 3 B/pixel of the tonemapped image cross to the host instead of the
// 12 B/pixel float sum.  It moves the bytes in wide pieces: a thread
// takes 12 floats (4 pixels' worth) per trip, as three 16-byte loads a
// block apart (each warp load is one contiguous 512-byte piece), and
// writes each 16-byte piece's 4 bytes as one 32-bit store.  The grid is
// as many blocks as the card holds at once, and a grid-stride loop walks
// the array; the floats past the last whole 16-byte piece (or all of
// them, when accum is not 16-byte aligned) take a scalar loop.  On an
// H100 that is not what bounds it (PERF.md): each byte needs one IEEE
// powf, about a hundred instructions, and running them takes longer than
// moving the bytes.
//
// Built with --fmad=false: contracting p * 255 + 0.5 into an FMA would
// move the truncation at quantization boundaries away from the plain
// PyTorch version and the NumPy reference.  inv_spp and gamma come from
// the host as float32, so every implementation uses the same constants.
// Launched on the caller's stream; allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPieces = 3;  // 16-byte pieces per thread per trip

__device__ __forceinline__ unsigned int tone(float a, float inv_spp,
                                             float gamma) {
  float x = a * inv_spp;
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  const float p = powf(x, gamma);
  return static_cast<unsigned int>(
      static_cast<unsigned char>(static_cast<int>(p * 255.0f + 0.5f)));
}

__device__ __forceinline__ unsigned int tone4(const float4& v, float inv_spp,
                                              float gamma) {
  return tone(v.x, inv_spp, gamma) | (tone(v.y, inv_spp, gamma) << 8) |
         (tone(v.z, inv_spp, gamma) << 16) | (tone(v.w, inv_spp, gamma) << 24);
}

// pieces = the 16-byte pieces of accum read as float4 (0 when accum is
// not 16-byte aligned); floats from 4 * pieces on go one at a time.
__global__ void __launch_bounds__(kThreads)
    tonemap_kernel(const float* __restrict__ accum,
                   unsigned char* __restrict__ out, long long n,
                   long long pieces, float inv_spp, float gamma) {
  const float4* __restrict__ in4 = reinterpret_cast<const float4*>(accum);
  unsigned int* __restrict__ out4 = reinterpret_cast<unsigned int*>(out);
  const long long span = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads * kPieces + threadIdx.x;
  for (long long base = first; base < pieces; base += span * kPieces) {
    float4 v[kPieces];
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const long long i = base + j * kThreads;
      if (i < pieces) v[j] = __ldg(in4 + i);
    }
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const long long i = base + j * kThreads;
      if (i < pieces) out4[i] = tone4(v[j], inv_spp, gamma);
    }
  }
  const long long tail =
      4 * pieces + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = tail; i < n; i += span) {
    out[i] =
        static_cast<unsigned char>(tone(__ldg(accum + i), inv_spp, gamma));
  }
}

}  // namespace

// The grid that fills the current device: SMs x resident blocks.  The
// caller asks once per device.  Returns a CUDA error (0 = done).
extern "C" int trt_tonemap_grid(int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tonemap_kernel,
                                                      kThreads, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// n = number of floats (3 per pixel); out is 4-byte aligned; grid from
// trt_tonemap_grid (fewer blocks are launched when fewer have work).
// Returns the CUDA error of the launch (0 = launched), 1
// (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int trt_tonemap_launch(const float* accum, unsigned char* out,
                                  long long n, float inv_spp, float gamma,
                                  int grid, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 4 != 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pieces =
      reinterpret_cast<uintptr_t>(accum) % 16 == 0 ? n / 4 : 0;
  const long long by_pieces =
      (pieces + kThreads * kPieces - 1) / (kThreads * kPieces);
  const long long by_tail = (n - 4 * pieces + kThreads - 1) / kThreads;
  const long long needed = by_pieces > by_tail ? by_pieces : by_tail;
  const long long blocks = grid < needed ? grid : needed;
  tonemap_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(accum, out, n, pieces,
                                                        inv_spp, gamma);
  return static_cast<int>(cudaGetLastError());
}

// Progressive-accumulator tonemap for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tryraytrace_tpu/ops/pallas_tonemap.py
// (_tonemap_kernel): for every float of the radiance sum accum [N, 3],
//     out = trunc(clamp(accum * inv_spp, 0, 1) ^ gamma * 255 + 0.5)
// as uint8 -- the reference's toInt (common.h:126-128).
//
// The kernel is bound by bytes: it reads 12 B and writes 3 B per pixel
// and does a handful of flops per float.  It exists so that only the
// 3 B/pixel of the tonemapped image cross to the host instead of the
// 12 B/pixel float sum.  One thread per float: neighbouring threads
// touch neighbouring addresses, so loads and stores coalesce.
//
// Built with --fmad=false: contracting p * 255 + 0.5 into an FMA would
// move the truncation at quantization boundaries away from the plain
// PyTorch version and the NumPy reference.  inv_spp and gamma come from
// the host as float32, so every implementation uses the same constants.
// Launched on the caller's stream; allocates nothing.

#include <cuda_runtime.h>

namespace {

__global__ void tonemap_kernel(const float* __restrict__ accum,
                               unsigned char* __restrict__ out,
                               long long n, float inv_spp, float gamma) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = accum[i] * inv_spp;
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  float p = powf(x, gamma);
  out[i] = static_cast<unsigned char>(static_cast<int>(p * 255.0f + 0.5f));
}

}  // namespace

// n = number of floats (3 per pixel).  Returns cudaGetLastError() after
// the launch, so a refused launch is reported to the caller.
extern "C" int trt_tonemap_launch(const float* accum, unsigned char* out,
                                  long long n, float inv_spp, float gamma,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  tonemap_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(accum, out, n,
                                                        inv_spp, gamma);
  return static_cast<int>(cudaGetLastError());
}

// The persistent engine's service pass for Hopper (sm_90a): one thread a
// lane shades, textures and regenerates that lane, in one launch a round.
//
// What it replaces.  On the TPU the pass is the service half of the
// engine's XLA-fused loop body (tryraytrace_tpu/engine/persistent.py:
// _service_select :776, _service_shade :793, _shade_prepare :1166,
// _shade_finish :1265 and _refill :1450, fused into _step_quad :948);
// it is not a Pallas kernel.  Its plain version is the eager block of
// tryraytrace_tpu_torch/engine/persistent.py (_service_select, the row
// gather, _service_shade), and the kernel is held to it field for field:
// every product and sum below is rounded on its own (built with
// --fmad=false, no fast math, so x / y and 1.0f / x are IEEE), sums of
// three run left to right, sqrt, pow, cos and sin are taken in double and
// rounded once to float as core/vec.py does, a multiply by a reciprocal
// stays one and a division stays a division, and every constant is the
// float32 rounding the tensor code compares or multiplies with (the
// host passes the ones that come from the configuration).
//
// Per lane, in the eager order:
//   - SHADEG: fetch the hit's material row from the unified table (two
//     triangles a row when pack == 2), build the shading frame
//     (ops/shade.py surface: face normal, smooth normal, planar or
//     interpolated UVs); a textured hit is parked in TEXG with its
//     material stashed (so, sd, pend, tstash) and its tile row in cur;
//   - TEXG: the bilinear sample from the tile row at cur, the material
//     from the stash;
//   - every lane made ready: the bounce's seven draws, emission, Russian
//     roulette, the exclusive spec / trans / diff branch and NEE with the
//     light pick (ops/shade.py scatter), the mode transitions;
//   - REFILL (the lanes the walk ended and those the shade just ended):
//     sanitize the sample, add it to the pixel's sum, start the pixel's
//     next sample (seed schedule, camera ray) or retire the lane.
// DONE, TRAVERSE and SHADOW lanes cost a thread one mode read.
//
// What bounds it on this card.  A serviced lane reads and writes its
// state (about 200 bytes each way in the engine's layout: int64 mode,
// cur, hit_id, depth, sample, seed, pix; float [n, 3] vectors; the
// 10-float texture stash) plus one 148- or 300-byte material row or a
// 300-byte tile row from L2 (the unified table is ~10 MB on the main
// path, and lanes that hit one triangle share its row).  Its arithmetic,
// a few double sqrt, cos, sin and pow calls a lane (11, 13, 13 and 83
// FP64 instructions on sm_90a), takes a seventh of the byte time at the
// card's FP64 rate, so the bytes bound it; but issuing that arithmetic
// and the integer work around it, with ~24 warps an SM, is what keeps it
// above the bound.
//
// What the design does about it.
//   - Only the branch a lane takes is computed.  The eager block computes
//     the specular, refracted and diffuse directions and the light sample
//     for every lane and keeps one (the TPU's lockstep select); here a
//     lane computes the one its draw picks, the refraction's second
//     perturbation only when roughness > 0, the reflection only on total
//     internal reflection, the light sample only on the diffuse branch,
//     the Fresnel weights only for a lane still alive, and a barycentric
//     only for the smooth normal or a textured hit's UVs.  A lane whose
//     path ends before a branch keeps the diffuse direction the select
//     leaves it (a retired lane's state keeps it), and skips it when its
//     refill overwrites it with a camera ray.  Every value kept is the
//     same sequence of rounded operations as before, so the same float.
//     Against the kernel that computed every branch this took 14-33% off
//     every state the engine makes (the main path's fresh state 0.1205
//     -> 0.0868 ms; NVIDIA H100 80GB HBM3, 700 W;
//     scripts/time_torch_service.py).
//   - Lanes are served in lane order, one a thread.  Listing a block's
//     lanes by mode in shared memory, so that a warp runs one mode's
//     code, and gathering the lanes that need service from several
//     chunks into persistent blocks were both built and measured: the
//     first cost 4-13% on every state the engine makes (its barriers and
//     the second list for the refill cost more than the divergence
//     saved: a SHADEG and a TEXG lane differ only in their cheap first
//     half) and won only on a seed-made state that mixes every mode in
//     every warp; the second cost a quarter on full states and gained a
//     tenth on a state with 10% of its lanes live, whose time is set by
//     the scattered 32-byte sectors its live lanes touch in each field,
//     which no order of the threads changes (the round loop compacts
//     such a wave on the host).
//   - Occupancy: 256 threads, no minimum of blocks.  At the 72
//     registers ptxas picks (no spills; a 40-byte stack for the double
//     trig reduction) three blocks fit an SM; forcing four (64
//     registers) spills and was slower on most states.
//   - The round's counts.  The kernel adds the paths it starts (continued
//     + camera) and the shadow rays it fires straight into the wave's
//     running int64 totals, and leaves the count of lanes not DONE in
//     one of two slots that the rounds take in turn; block 0 zeroes the
//     other slot, for the next round.  So the host launches nothing for
//     the counts and reads one number a round.  Each block counts with
//     __syncthreads_count and adds with one 64-bit atomic a total, which
//     is free of order; each pixel's sum is added by that pixel's own
//     thread, with no float atomics.
// Launched on the caller's stream; allocates nothing.
//
// The pass's device code (prepare, texture_lane, finish, refill and one
// lane's service, serve) is in service_device.cuh, which the wave kernel
// (wave_advance.cu) shares.

#include "service_device.cuh"

namespace trt_service {

__global__ void __launch_bounds__(kThreads)
    service_pass_kernel(const Params p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.totals[kLive + 1 - p.slot] = 0;
  }
  int cont = 0, fire = 0;
  bool started = false, live = false;
  if (i < p.n) live = serve(p, i, &cont, &fire, &started);
  const int n_cont = __syncthreads_count(cont);
  const int n_fire = __syncthreads_count(fire);
  const int n_start = __syncthreads_count(started);
  const int n_live = __syncthreads_count(live);
  if (threadIdx.x == 0) {
    if (n_cont + n_start) {
      atomicAdd(p.totals + kPathRays,
                static_cast<unsigned long long>(n_cont + n_start));
    }
    if (n_fire) {
      atomicAdd(p.totals + kShadowRays,
                static_cast<unsigned long long>(n_fire));
    }
    if (n_live) {
      atomicAdd(p.totals + kLive + p.slot,
                static_cast<unsigned long long>(n_live));
    }
  }
}

}  // namespace trt_service

// The sizes of the parameter arrays trt_service_launch reads, for the
// caller to check against its own: floats, ints, pointers, totals.
extern "C" int trt_service_layout(int* out) {
  out[0] = trt_service::kNumFloats;
  out[1] = trt_service::kNumInts;
  out[2] = trt_service::kNumPtrs;
  out[3] = trt_service::kNumTotals;
  return 0;
}

// One service pass over n lanes on `stream`.  floats / ints are host
// arrays of the constants (ops/service.py ServiceParams), ptrs a host
// array of the device pointers in PtrParam order: the unified table, the
// light rows, the texture metas, then the state fields (int64 mode, cur,
// hit_id, depth, sample, seed, pix; float32 d_min, o, d, tp, rad, so,
// sd, smax, pend, out, tstash (null without textures); bool prev_spec,
// cont_after_shadow), then the wave's four int64 totals: the pass adds
// the path rays it starts (continued + camera) to the first and the
// shadow rays it fires to the second, adds the count of lanes not DONE
// after it to slot 2 + `slot` (zero at launch) and zeroes slot 3 - `slot`.
// Returns the CUDA error of the launch (0 = launched), 1
// (cudaErrorInvalidValue) for arguments it does not take.
extern "C" int trt_service_launch(const float* floats, const long long* ints,
                                  void* const* ptrs, long long n, int slot,
                                  void* stream) {
  using namespace trt_service;
  if (n <= 0) return 0;
  Params p;
  if (!unpack_params(floats, ints, ptrs, n, slot, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  service_pass_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

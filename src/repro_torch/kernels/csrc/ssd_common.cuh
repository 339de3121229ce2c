// Pieces shared by the SSD scan's kernels, forward (ssd_scan.cu) and
// backward (ssd_scan_bwd.cu).  In an anonymous namespace, as hopper.cuh:
// each kernel source has its own copy.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int MAX_Q = 256;        // the largest chunk

// One warp's inclusive prefix sum of v[0, n) in shared memory, n a multiple
// of 32: each lane sums a run of n / 32, then the lanes' totals are scanned
// with shuffles.
__device__ void warp_scan(float* v, int n, int lane) {
  const int per = n / 32, base = lane * per;
  float run = 0.f;
  for (int i = 0; i < per; ++i) run += v[base + i];
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float acc = incl - run;
  for (int i = 0; i < per; ++i) {
    acc += v[base + i];
    v[base + i] = acc;
  }
}

// f(std::integral_constant<int, d>) for d, a head or state width the
// kernels take; cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t by_width(int d, F&& f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

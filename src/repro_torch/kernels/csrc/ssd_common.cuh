// Pieces shared by the SSD scan's kernels, forward (ssd_scan.cu) and
// backward (ssd_scan_bwd.cu): the chunk's cum scan, the dispatch over the
// widths, and the chunk-state product on wgmma.  In an anonymous
// namespace, as hopper.cuh: each kernel source has its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

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

// One warpgroup's chunk-state product, the forward's dS_c and the
// backward's dS_c and E_c: out[p][n] = sum_{j < kq} w_j u_j[p] v_j[n] for
// p < P and NB columns n (out's rows N apart), with u's rows in shared
// memory as bf16 (Us, XS elements apart), the weights w in fp32 and v's NB
// columns an N-major swizzled tile (SwTile<MAX_Q, NB> at Va).  A = (w u)^T
// from registers, split into bf16 high and low parts; B = v, exact.  kq is
// a multiple of 64, the rows past the chunk's zero: the loop over k-steps
// has no condition, as wgmma issued under one is fenced by ptxas.
template <int P, int N, int NB, int XS>
__device__ __forceinline__ void chunk_state_product(
    const __nv_bfloat16* Us, const float* wts, uint32_t Va, int kq,
    float* out) {
  using VT = SwTile<MAX_Q, NB>;
  constexpr int NT = NB / 8, TILE = 64;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int m0 = 0; m0 < P; m0 += TILE) {      // P = 128: two row tiles
    const int p0 = m0 + warp * 16 + g, p1 = p0 + 8;   // this thread's rows
    float d[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
    auto a = [&](int p, int j) {
      return p < P ? wts[j] * __bfloat162float(Us[j * XS + p]) : 0.f;
    };
    for (int k0 = 0; k0 < kq; k0 += 64) {
      // A for four k-steps of 16 rows j, as mma.sync A fragments
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j = k0 + kk * 16 + 2 * q;
        split_bf16(a(p0, j), a(p0, j + 1), ah[kk][0], al[kk][0]);
        split_bf16(a(p1, j), a(p1, j + 1), ah[kk][1], al[kk][1]);
        split_bf16(a(p0, j + 8), a(p0, j + 9), ah[kk][2], al[kk][2]);
        split_bf16(a(p1, j + 8), a(p1, j + 9), ah[kk][3], al[kk][3]);
      }
      fence_regs(d);
      fence_regs(ah);
      fence_regs(al);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = VT::n_major(Va, k0 / 16 + kk);
        wgmma_rs<1>(d, ah[kk], desc, 1);
        wgmma_rs<1>(d, al[kk], desc, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d);
      fence_regs(ah);
      fence_regs(al);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * q;
      if (p0 < P)
        *reinterpret_cast<float2*>(out + long(p0) * N + col) =
            make_float2(d[n][0], d[n][1]);
      if (p1 < P)
        *reinterpret_cast<float2*>(out + long(p1) * N + col) =
            make_float2(d[n][2], d[n][3]);
    }
  }
}

}  // namespace

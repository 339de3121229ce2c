// O = P V on one warpgroup, as flash_attention_wgmma's P V step
// (src/repro_torch/kernels/csrc/flash_attention.cu): P 64 x 64 bf16 from
// registers, V [64 keys][N] bf16 N-major in shared memory, in column blocks
// of SW bytes a row (64 rows a block), swizzled as the kernel stores it.
// Each line runs one wgmma setting (N, swizzle, leading and stride byte
// offsets, one product or one per 32 columns) and prints its max abs error
// against a host reference; OK below 1e-2.  On an H100:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O2 \
//       -o wgmma_probe scripts/wgmma_probe.cu && ./wgmma_probe
#include <cuda_bf16.h>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(mode) << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}
__device__ __forceinline__ void wg32(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wg64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wg128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v; v.x = lo; v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// variant: 0 single product; 1 products of 32 columns, one per 64-byte block
template <int N>
__global__ void probe(const __nv_bfloat16* P, const __nv_bfloat16* V, float* O,
                      int sw, int lbo, int sbo, int variant, int base_off) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* tile = smem + base_off;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int per_row = sw / 16, block = 64 * sw;
  for (int e = tid; e < 64 * N / 8; e += 128) {
    const int r = e / (N / 8), ch = e % (N / 8);
    int off = (ch / per_row) * block + r * sw + (ch % per_row) * 16;
    off ^= ((off >> 7) & (per_row - 1)) << 4;
    *reinterpret_cast<uint4*>(tile + off) =
        *reinterpret_cast<const uint4*>(V + r * N + ch * 8);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t pf[4][4];
  const int row = warp * 16 + g;
  for (int kk = 0; kk < 4; ++kk) {
    const int k0 = kk * 16 + 2 * c;
    pf[kk][0] = pack(P[row * 64 + k0], P[row * 64 + k0 + 1]);
    pf[kk][1] = pack(P[(row + 8) * 64 + k0], P[(row + 8) * 64 + k0 + 1]);
    pf[kk][2] = pack(P[row * 64 + k0 + 8], P[row * 64 + k0 + 9]);
    pf[kk][3] = pack(P[(row + 8) * 64 + k0 + 8], P[(row + 8) * 64 + k0 + 9]);
  }
  float o[N / 8][4];
  for (int n = 0; n < N / 8; ++n)
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const uint32_t mode = sw == 128 ? 1 : (sw == 64 ? 2 : 3);
  const uint32_t Vc = smem_addr(tile);
  fence_regs(o);
  fence_regs(pf);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t vk = Vc + kk * 16 * sw;
    if constexpr (N == 32) {
      wg32(o, pf[kk], smem_desc(vk, lbo, sbo, mode));
    } else if constexpr (N == 64) {
      if (variant == 1) {
        using Half = float[4][4];
        wg32(*reinterpret_cast<Half*>(&o[0]), pf[kk], smem_desc(vk, lbo, sbo, mode));
        wg32(*reinterpret_cast<Half*>(&o[4]), pf[kk], smem_desc(vk + block, lbo, sbo, mode));
      } else {
        wg64(o, pf[kk], smem_desc(vk, lbo, sbo, mode));
      }
    } else {
      wg128(o, pf[kk], smem_desc(vk, lbo, sbo, mode));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(pf);
  for (int n = 0; n < N / 8; ++n)
    for (int e = 0; e < 4; ++e)
      O[(row + 8 * (e / 2)) * N + n * 8 + 2 * c + e % 2] = o[n][e];
}

static float bf(float x) { return __bfloat162float(__float2bfloat16(x)); }

template <int N>
void run(const char* name, int sw, int lbo, int sbo, int variant, int base_off = 0) {
  std::vector<__nv_bfloat16> hp(64 * 64), hv(64 * N);
  std::vector<float> fp(64 * 64), fv(64 * N), ref(64 * N, 0.f), got(64 * N);
  srand(1);
  for (int i = 0; i < 64 * 64; ++i) { fp[i] = bf(rand() / (float)RAND_MAX - 0.5f); hp[i] = __float2bfloat16(fp[i]); }
  for (int i = 0; i < 64 * N; ++i) { fv[i] = bf(rand() / (float)RAND_MAX - 0.5f); hv[i] = __float2bfloat16(fv[i]); }
  for (int r = 0; r < 64; ++r)
    for (int n = 0; n < N; ++n) {
      double s = 0; for (int k = 0; k < 64; ++k) s += fp[r * 64 + k] * fv[k * N + n];
      ref[r * N + n] = s;
    }
  __nv_bfloat16 *dp, *dv; float* dO;
  cudaMalloc(&dp, 64 * 64 * 2); cudaMalloc(&dv, 64 * N * 2); cudaMalloc(&dO, 64 * N * 4);
  cudaMemcpy(dp, hp.data(), 64 * 64 * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(dv, hv.data(), 64 * N * 2, cudaMemcpyHostToDevice);
  cudaMemset(dO, 0, 64 * N * 4);
  const int smem = 65536 + base_off;
  cudaFuncSetAttribute(probe<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe<N><<<1, 128, smem>>>(dp, dv, dO, sw, lbo, sbo, variant, base_off);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(got.data(), dO, 64 * N * 4, cudaMemcpyDeviceToHost);
  double mx = 0; int first = -1;
  for (int i = 0; i < 64 * N; ++i) { double d = fabs(got[i] - ref[i]); if (d > 1e-2 && first < 0) first = i; mx = fmax(mx, d); }
  printf("%-52s N=%3d sw=%3d lbo=%5d sbo=%5d var=%d base=%4d: %s max_abs_err=%.4g%s",
         name, N, sw, lbo, sbo, variant, base_off, cudaGetErrorString(err), mx, mx < 1e-2 ? "  OK\n" : "  WRONG");
  if (first >= 0) printf(" (first bad row %d col %d)\n", first / N, first % N);
  cudaFree(dp); cudaFree(dv); cudaFree(dO);
}

int main() {
  run<32>("n32, one 64B atom (control)", 64, 4096, 512, 0);
  run<64>("n64 as two n32 (the kernel's workaround)", 64, 4096, 512, 1);
  run<64>("n64, 64B swizzle, LBO=block SBO=8 rows (kernel)", 64, 4096, 512, 0);
  run<64>("n64, 64B swizzle, LBO/SBO swapped", 64, 512, 4096, 0);
  run<64>("n64, 128B swizzle, one atom", 128, 8192, 1024, 0);
  run<64>("n64, 128B swizzle, one atom, LBO=16", 128, 16, 1024, 0);
  run<128>("n128, 128B swizzle, LBO=block (kernel, D=128)", 128, 8192, 1024, 0);
  run<128>("n128, 64B swizzle, 4 atoms, LBO=block", 64, 4096, 512, 0);
  run<64>("n64, 32B swizzle, LBO=block", 32, 2048, 256, 0);
  run<64>("n64, 64B swizzle (kernel), tile base +512", 64, 4096, 512, 0, 512);
  run<64>("n64, 64B swizzle (kernel), tile base +1024", 64, 4096, 512, 0, 1024);
  return 0;
}

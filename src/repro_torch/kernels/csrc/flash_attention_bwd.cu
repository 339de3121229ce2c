// The backward pass of prefill attention for Hopper (sm_90a), written by
// hand.
//
// No TPU kernel is replaced: no Pallas kernel in repro/ has a backward, and
// the JAX model trains through blocked_attention
// (src/repro/models/layers.py:170), which XLA differentiates, recomputing
// the scores block by block under jax.checkpoint.  This computes the same
// gradient of the function that flash_attention.cu computes (GQA, causal
// or not, a sliding window, a tanh softcap, kv_len masking the tail of the
// keys), from q, k, v, the forward's output o and its row log-sum-exp lse,
// and the output's gradient dO:
//   P   = exp(s - lse), s the scaled (and capped) score, 0 where masked
//   dV  = P^T dO                         dP = dO V^T
//   dS  = P o (dP - Delta) [o (1 - tanh^2(s_raw scale / cap)) under a cap]
//   dQ  = scale dS K                     dK = scale dS^T Q
// with Delta = rowsum(dO o O).  Three launches on the current stream:
//   1. fa_bwd_delta: Delta in fp32, one warp a (batch, position, head) row;
//   2. dK/dV: one block per (64-key KV tile, KV head, batch).  It walks
//      the G query heads of its group and, for each, the q tiles that see
//      its KV tile (the forward's band skipping,
//      kernels/flash_attention.py:_tile_needed), recomputing P and dS tile
//      by tile and summing dK and dV in registers: no other block writes
//      them, so there are no atomics;
//   3. dQ: one block per (64-row q tile, head, batch), walking the KV
//      tiles its band holds and summing dQ in registers.
// Every sum is fp32 in a fixed order, so the result does not change from
// run to run.  Delta is the caller's workspace, one per call.  Keys at or
// past kv_len are masked, so their rows of dK and dV come out zero.
//
// Layouts as the forward's: q/o/dO/dQ [B, S, H, D], k/v/dK/dV
// [B, T, KVH, D], contiguous, all bf16 or all fp32; lse and Delta fp32
// [B, H, S].  Head dims 32, 64, 128, 192 and 256, as the forward's.
//
// What bounds it: five products of 2 D operations a (q, k) pair (2.5x the
// forward's four D), far above the card's ridge, so the tensor cores set
// the pace.  A first version that ran every product in fp32 on CUDA cores
// (67 TFLOP/s at most) out of fp32 shared-memory tiles, one block an SM,
// reached 1.4 % of the bound.  bf16 inputs take the wgmma kernels
// (fa_bwd_dkdv_wgmma, fa_bwd_dq_wgmma), on the forward's pattern:
//   * every tile is bf16 in shared memory in the swizzled layout wgmma's
//     descriptors read (SwTile, hopper.cuh), copied by cp.async, zero-filled
//     past S or T; the tiles a block walks over (Q and dO, with their lse
//     and Delta rows, in the dK/dV pass; K and V in the dQ pass) go through
//     a two-stage ring, so tile j+1 loads while tile j is computed;
//   * the score products read both operands from shared memory (wgmma_ss,
//     m64n64k16): S^T = K Q^T and dP^T = V dO^T in the dK/dV pass,
//     S = Q K^T and dP = dO V^T in the dQ pass.  No A fragment lives in
//     registers, let alone across tiles (flash_attention.cu's header says
//     why that matters);
//   * P and dS are made in fp32 in the accumulators' layout (ex2 in log2
//     units, lse and Delta indexed by column in the dK/dV pass and by row
//     in the dQ pass), packed pairwise to bf16 A fragments as the forward
//     packs P, and never touch shared memory: dV += P^T dO and
//     dK += dS^T Q (Q and dO read N-major from the same tiles), and
//     dQ += dS K (K read N-major);
//   * the mask runs only on tiles that cross an edge of the band or of S;
//     no product is skipped or issued under a condition inside a tile;
//   * registers: a warpgroup's dK and dV accumulators take D fp32 a
//     thread, S^T and dP^T 64 more.  At D = 192 and 256 the dK/dV block
//     has two warpgroups, each owning half of dK's and dV's columns and
//     both computing the whole S^T and dP^T (at 192 the tiles use 64-byte
//     swizzle blocks, so a 96-column half starts on a block).  The dQ
//     block is one warpgroup: dQ takes D / 2 registers, 128 at D = 256.
//     Shared memory: six tiles (K, V and a two-stage ring of two), 98 KB
//     at D = 128 (two blocks an SM), 196 KB at D = 256.
// The passes still recompute S and dP each (seven products where five
// would do); PERF.md has the times beside the bound.
// fp32 inputs take fa_bwd_dkdv_simt and fa_bwd_dq_simt, on CUDA cores in
// fp32 (the tensor cores would compute in TF32; the fp32 path is held to
// 2e-5): fp32 tiles in shared memory, rows padded by one float so a column
// read is free of bank conflicts, each of 256 threads owning a block of
// each score tile and rows of the D-wide sums.  At D = 256 their q tiles
// are 32 rows, so that the fp32 tiles fit in a block's 227 KB.  The model
// trains in bf16, so the training path never reaches them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows a tile (bf16; fp32 below 256)
constexpr int BK = 64;            // keys a tile
constexpr int DELTA_WARPS = 8;    // rows a block of the Delta pass
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int kv_len,
                                        int causal, int window) {
  bool ok = kpos < kv_len;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// Does every (query, key) of the 64 x 64 tile lie inside the band, so that
// the tile needs no mask?  (flash_attention.cu's tile_full.)
__device__ __forceinline__ bool tile_full(int q_start, int k_start,
                                          int kv_len, int causal,
                                          int window) {
  const int k_end = k_start + BK - 1;
  bool full = k_end < kv_len;
  if (causal) full = full && k_end <= q_start;
  if (window > 0) full = full && k_start > q_start + BQ - 1 - window;
  return full;
}

// ------------------------------------------------------------ 1. Delta

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * DELTA_WARPS)
fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int S, int H, long rows) {
  const long row = long(blockIdx.x) * DELTA_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;              // the whole warp leaves together
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {                      // row = (b * S + s) * H + h
    const long b = row / (long(S) * H);
    const int s = int((row / H) % S), h = int(row % H);
    delta[(b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------- bf16: tensor cores

constexpr int WG_THREADS = 128;   // a warpgroup
constexpr int STAGES = 2;         // tiles in the ring

template <int D>
struct Bwd {
  // warpgroups of the dK/dV block, each owning DW of dK's and dV's columns
  static constexpr int WGS = D >= 192 ? 2 : 1;
  static constexpr int DW = D / WGS;
  // 64-byte swizzle blocks at 192, so that a 96-column half starts on one
  static constexpr int SW = D == 192 ? 64 : SwTile<64, D>::SW;
  using Tile = SwTile<64, D, SW>;
  // K, V and a two-stage ring of Q and dO (the dK/dV pass, with 2 x 64
  // floats of lse and Delta a stage), or Q, dO and a ring of K and V (dQ)
  static constexpr size_t DKDV_SMEM =
      size_t(2 + 2 * STAGES) * Tile::BYTES + sizeof(float) * STAGES * 2 * BQ;
  static constexpr size_t DQ_SMEM = size_t(2 + 2 * STAGES) * Tile::BYTES;
};

// Blocks an SM holds by shared memory (227 KB a block at most, 228 KB an
// SM, 1 KB reserved a block).
constexpr int blocks_per_sm(size_t smem) {
  return 2 * (smem + 1024) <= 233472 ? 2 : 1;
}

// P and dS of one score-tile element, in place: s (the raw score q.k)
// becomes P = exp(s scale - lse) (0 unless ok), dp becomes
// dS = P (dp - Delta), times 1 - tanh^2 under a cap; dS leaves out the
// factor `scale` (applied to dQ and dK once).  lse2 = lse log2(e);
// qk_scale = scale log2(e), or scale / cap under a cap.
template <bool SOFTCAP>
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2,
                                     float delta, bool ok, float qk_scale,
                                     float cap_log2) {
  float p, dcap = 1.f;
  if (SOFTCAP) {
    const float t = tanhf(s * qk_scale);
    p = ex2(fmaf(t, cap_log2, -lse2));
    dcap = 1.f - t * t;
  } else {
    p = ex2(fmaf(s, qk_scale, -lse2));
  }
  p = ok ? p : 0.f;
  s = p;
  dp = p * (dp - delta) * dcap;
}

// The A fragment of columns kk*16 + [0, 16) of a 64 x 64 accumulator tile:
// n-tiles 2kk and 2kk+1, packed pairwise to bf16 (flash_attention.cu's
// p_fragment).
__device__ __forceinline__ void a_fragment(const float (&s)[8][4], int kk,
                                           uint32_t (&f)[4]) {
  f[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  f[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  f[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  f[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// The two score products of a tile, both operands K-major in shared
// memory: s = A1 B1^T and dp = A2 B2^T over D, each 64 x 64.
template <int D>
__device__ __forceinline__ void score_products(float (&s)[8][4],
                                               float (&dp)[8][4],
                                               uint32_t a1, uint32_t b1,
                                               uint32_t a2, uint32_t b2) {
  using Tile = typename Bwd<D>::Tile;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, Tile::k_major(a1, kk), Tile::k_major(b1, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(dp, Tile::k_major(a2, kk), Tile::k_major(b2, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
}

// dK, dV: one block per (64-key tile, KV head, batch), WGS warpgroups.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(WG_THREADS * Bwd<D>::WGS,
                                  blocks_per_sm(Bwd<D>::DKDV_SMEM))
fa_bwd_dkdv_wgmma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int S, int T_len, int H,
                  int KVH, int kv_len, int causal, int window, float softcap,
                  float scale) {
  using Tile = typename Bwd<D>::Tile;
  constexpr int THREADS = WG_THREADS * Bwd<D>::WGS;
  constexpr int DW = Bwd<D>::DW;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Ks = smem_raw;
  unsigned char* Vs = Ks + Tile::BYTES;
  unsigned char* ring = Vs + Tile::BYTES;   // stage st: Q at 2 st, dO 2 st+1
  // stage st: lse at rows + 2 st BQ, Delta at rows + (2 st + 1) BQ
  float* rows = reinterpret_cast<float*>(ring + 2 * STAGES * Tile::BYTES);

  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int k_start = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const long q_stride = long(H) * D, kv_stride = long(KVH) * D;
  const long kv_off = (long(b) * T_len + k_start) * kv_stride + long(kvh) * D;

  // the q tiles that see this KV tile, [qlo, qlo + nqt), for each of the
  // group's G heads: iteration it is head kvh G + it / nqt
  const int nq = (S + BQ - 1) / BQ;
  const int qlo = causal ? k_start / BQ : 0;
  int qhi = nq - 1;
  if (window > 0) qhi = min(qhi, (k_start + BK - 2 + window) / BQ);
  const int nqt = k_start < kv_len ? max(qhi - qlo + 1, 0) : 0;
  const int n_it = G * nqt;

  auto issue = [&](int it) {
    if (it < n_it) {
      const int h = kvh * G + it / nqt, q0 = (qlo + it % nqt) * BQ;
      const int st = it % STAGES;
      const long q_off = (long(b) * S + q0) * q_stride + long(h) * D;
      load_sw_tile<BQ, D, THREADS, Tile::SW>(ring + 2 * st * Tile::BYTES,
                                             q + q_off, q_stride, S - q0,
                                             tid);
      load_sw_tile<BQ, D, THREADS, Tile::SW>(
          ring + (2 * st + 1) * Tile::BYTES, dout + q_off, q_stride, S - q0,
          tid);
      if (tid < 2 * BQ) {                 // lse, then Delta, zero past S
        const bool ok = q0 + tid % BQ < S;
        const float* src = (tid < BQ ? lse : delta) +
                           (long(b) * H + h) * S + q0 + tid % BQ;
        cp_async4(smem_addr(rows + 2 * st * BQ + tid), ok ? src : lse, ok);
      }
    }
    cp_async_commit();
  };
  load_sw_tile<BK, D, THREADS, Tile::SW>(Ks, k + kv_off, kv_stride,
                                         T_len - k_start, tid);
  load_sw_tile<BK, D, THREADS, Tile::SW>(Vs, v + kv_off, kv_stride,
                                         T_len - k_start, tid);
  issue(0);                               // group: K, V and iteration 0

  const float qk_scale = SOFTCAP ? scale / softcap : scale * LOG2E;
  const float cap_log2 = softcap * LOG2E;
  const uint32_t Kc = smem_addr(Ks), Vc = smem_addr(Vs);
  // this warpgroup's columns of dK and dV: from block wg DW 2 / SW on
  const uint32_t half = wg * (DW * 2 / Tile::SW) * Tile::BLOCK;
  const int krow = k_start + warp * 16 + g;   // this thread's keys, +0, +8
  float dk_acc[DW / 8][4], dv_acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    // iteration it has landed; after the barrier the stage of it-1 is
    // free for it+1
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    issue(it + 1);
    const int st = it % STAGES, q0 = (qlo + it % nqt) * BQ;
    const uint32_t Qc = smem_addr(ring + 2 * st * Tile::BYTES);
    const uint32_t Dc = Qc + Tile::BYTES;
    const float* lrow = rows + 2 * st * BQ;
    const float* drow = lrow + BQ;

    // S^T = K Q^T, dP^T = V dO^T: 64 keys x 64 queries
    float s[8][4], dp[8][4];
    score_products<D>(s, dp, Kc, Qc, Vc, Dc);

    // P^T and dS^T; a column is a query, so lse and Delta by column
    const bool masked = !tile_full(q0, k_start, kv_len, causal, window) ||
                        q0 + BQ > S;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * c;
      const float2 L = *reinterpret_cast<const float2*>(lrow + col);
      const float2 Dl = *reinterpret_cast<const float2*>(drow + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + col + e % 2, kpos = krow + 8 * (e / 2);
        const bool ok = !masked ||
                        (qpos < S && visible(qpos, kpos, kv_len, causal,
                                             window));
        p_ds<SOFTCAP>(s[n][e], dp[n][e], (e % 2 ? L.y : L.x) * LOG2E,
                      e % 2 ? Dl.y : Dl.x, ok, qk_scale, cap_log2);
      }
    }

    // dV += P^T dO, dK += dS^T Q: the fragments all packed before the
    // products, which read them while they run
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_fragment(s, kk, pf[kk]);
      a_fragment(dp, kk, dsf[kk]);
    }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pf);
    fence_regs(dsf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dv_acc, pf[kk], Tile::n_major(Dc + half, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dk_acc, dsf[kk], Tile::n_major(Qc + half, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pf);
    fence_regs(dsf);
  }
  cp_async_wait<0>();                     // no copy in flight (n_it = 0)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = krow + 8 * r;
    if (t >= T_len) continue;
    const long off = (long(b) * T_len + t) * kv_stride + long(kvh) * D +
                     wg * DW + 2 * c;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
          pack_bf16(dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// The KV tiles that touch the visible band of the q tile at q_start form
// one run [lo, hi] (hi < lo: none); flash_attention.cu's band.
__device__ __forceinline__ void band(int q_start, int kv_len, int causal,
                                     int window, int* lo, int* hi) {
  *hi = kv_len > 0 ? (kv_len - 1) / BK : -1;
  if (causal) *hi = min(*hi, (q_start + BQ - 1) / BK);
  *lo = 0;
  if (window > 0) {
    const int x = q_start - window - BK + 1;   // need k_start > x
    *lo = x < 0 ? 0 : x / BK + 1;
  }
}

// dQ: one warpgroup per (64-row q tile, head, batch).
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(WG_THREADS, blocks_per_sm(Bwd<D>::DQ_SMEM))
fa_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int S, int T_len, int H,
                int KVH, int kv_len, int causal, int window, float softcap,
                float scale) {
  using Tile = typename Bwd<D>::Tile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw;
  unsigned char* dOs = Qs + Tile::BYTES;
  unsigned char* ring = dOs + Tile::BYTES;  // stage st: K at 2 st, V 2 st+1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  // the causal q tiles with the most KV tiles start first
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_stride = long(H) * D, kv_stride = long(KVH) * D;
  const long q_off = (long(b) * S + q_start) * q_stride + long(h) * D;
  const __nv_bfloat16* kb = k + (long(b) * T_len * KVH + kvh) * D;
  const __nv_bfloat16* vb = v + (long(b) * T_len * KVH + kvh) * D;

  int lo, hi;
  band(q_start, kv_len, causal, window, &lo, &hi);
  auto issue = [&](int j) {
    if (j <= hi) {
      const int k0 = j * BK, st = (j - lo) % STAGES;
      load_sw_tile<BK, D, WG_THREADS, Tile::SW>(
          ring + 2 * st * Tile::BYTES, kb + k0 * kv_stride, kv_stride,
          T_len - k0, tid);
      load_sw_tile<BK, D, WG_THREADS, Tile::SW>(
          ring + (2 * st + 1) * Tile::BYTES, vb + k0 * kv_stride, kv_stride,
          T_len - k0, tid);
    }
    cp_async_commit();
  };
  load_sw_tile<BQ, D, WG_THREADS, Tile::SW>(Qs, q + q_off, q_stride,
                                            S - q_start, tid);
  load_sw_tile<BQ, D, WG_THREADS, Tile::SW>(dOs, dout + q_off, q_stride,
                                            S - q_start, tid);
  issue(lo);                              // group: Q, dO and tile lo

  // this thread's rows, qrow and qrow + 8: their lse (log2 units), Delta
  const int qrow = q_start + warp * 16 + g;
  const long row_head = (long(b) * H + h) * S;
  float lse2[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qrow + 8 * r < S;
    lse2[r] = in ? lse[row_head + qrow + 8 * r] * LOG2E : 0.f;
    drow[r] = in ? delta[row_head + qrow + 8 * r] : 0.f;
  }
  const float qk_scale = SOFTCAP ? scale / softcap : scale * LOG2E;
  const float cap_log2 = softcap * LOG2E;
  const uint32_t Qc = smem_addr(Qs), Dc = smem_addr(dOs);
  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int j = lo; j <= hi; ++j) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    issue(j + 1);
    const int st = (j - lo) % STAGES, k0 = j * BK;
    const uint32_t Kc = smem_addr(ring + 2 * st * Tile::BYTES);
    const uint32_t Vc = Kc + Tile::BYTES;

    // S = Q K^T, dP = dO V^T: 64 queries x 64 keys
    float s[8][4], dp[8][4];
    score_products<D>(s, dp, Qc, Kc, Dc, Vc);

    const bool masked = !tile_full(q_start, k0, kv_len, causal, window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qrow + 8 * (e / 2), kpos = k0 + 8 * n + 2 * c + e % 2;
        const bool ok = !masked || visible(qpos, kpos, kv_len, causal, window);
        p_ds<SOFTCAP>(s[n][e], dp[n][e], lse2[e / 2], drow[e / 2], ok,
                      qk_scale, cap_log2);
      }

    // dQ += dS K
    uint32_t dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_fragment(dp, kk, dsf[kk]);
    fence_regs(dq_acc);
    fence_regs(dsf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dq_acc, dsf[kk], Tile::n_major(Kc, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
    fence_regs(dsf);
  }
  cp_async_wait<0>();                     // no copy in flight (lo > hi)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* out = dq + (long(b) * S + row) * q_stride + long(h) * D +
                         2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          pack_bf16(dq_acc[n][2 * r] * scale, dq_acc[n][2 * r + 1] * scale);
  }
}

// ------------------------------------------------------- fp32: CUDA cores

constexpr int TY = 16;            // thread grid: TY x TX = 256 threads
constexpr int TX = 16;
constexpr int THREADS = TY * TX;
constexpr int CK = BK / TX;       // score columns a thread
constexpr int RK = BK / TY;       // keys a thread in the dK, dV sums
constexpr int PS = BK + 1;        // row stride of the P and dS tiles

// q rows a tile: 32 at D = 256, where four [64][D + 1] fp32 tiles would
// pass the 227 KB a block may have
template <int D>
__host__ __device__ constexpr int simt_q_rows() { return D == 256 ? 32 : 64; }

// Does the KV tile at k_start touch the visible band of the QT-row q tile
// at q_start?  (kernels/flash_attention.py:_tile_needed at 64 rows.)
__device__ __forceinline__ bool tile_needed(int q_start, int qt, int k_start,
                                            int kv_len, int causal,
                                            int window) {
  bool needed = k_start < kv_len;
  if (causal) needed = needed && k_start <= q_start + qt - 1;
  if (window > 0) needed = needed && k_start + BK - 1 > q_start - window;
  return needed;
}

// ROWS rows of D values (row r at src + r * stride) into a [ROWS][D + 1]
// tile; rows at or past `valid` are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long stride, int valid, int tid) {
  for (int e = tid; e < ROWS * D; e += THREADS) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < valid ? src[r * stride + d] : 0.f;
  }
}

// acc[i][j] = sum_d A[row ty*R + i][d] * B[row tx + j*TX][d] over two
// [.][D + 1] tiles: an (R TY) x 64 product of A and B^T.
template <int D, int R>
__device__ __forceinline__ void product_abt(float (&acc)[R][CK],
                                            const float* A, const float* B,
                                            int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[R], b[CK];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty * R + i) * DP + d];
#pragma unroll
    for (int j = 0; j < CK; ++j) b[j] = B[(tx + j * TX) * DP + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// P and dS of one (R TY) x 64 tile into shared memory, from the score and
// dP products (s, dp), the rows' lse and Delta: masked entries and rows
// past S take 0.  dS leaves out the factor `scale`.
template <bool SOFTCAP, int R>
__device__ __forceinline__ void p_and_ds(
    const float (&s)[R][CK], const float (&dp)[R][CK], float* Ps,
    float* dSs, const float* rowL, const float* rowD, int q_start,
    int k_start, int S, int kv_len, int causal, int window, float softcap,
    float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i, qpos = q_start + r;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int c = tx + j * TX, kpos = k_start + c;
      float x = s[i][j] * scale, dcap = 1.f;
      if (SOFTCAP) {
        const float t = tanhf(x / softcap);
        x = t * softcap;
        dcap = 1.f - t * t;
      }
      const bool ok = qpos < S && visible(qpos, kpos, kv_len, causal, window);
      const float p = ok ? expf(x - rowL[r]) : 0.f;
      if (Ps != nullptr) Ps[r * PS + c] = p;
      dSs[r * PS + c] = p * (dp[i][j] - rowD[r]) * dcap;
    }
  }
}

template <int D>
constexpr size_t dkdv_simt_smem() {
  constexpr size_t QT = simt_q_rows<D>();
  return sizeof(float) *
         (2 * size_t(BK) * (D + 1) + 2 * QT * (D + 1) + 2 * QT * PS + 2 * QT);
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_simt(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int S, int T_len, int H, int KVH,
                 int kv_len, int causal, int window, float softcap,
                 float scale) {
  constexpr int QT = simt_q_rows<D>();
  constexpr int RQ = QT / TY;           // score rows a thread
  constexpr int DP = D + 1;
  constexpr int AD = D / TX;            // D-wide columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;                     // [BK][DP]
  float* Vs = Ks + BK * DP;             // [BK][DP]
  float* Qs = Vs + BK * DP;             // [QT][DP]
  float* dOs = Qs + QT * DP;            // [QT][DP]
  float* Ps = dOs + QT * DP;            // [QT][PS]
  float* dSs = Ps + QT * PS;            // [QT][PS]
  float* rowL = dSs + QT * PS;          // [QT]
  float* rowD = rowL + QT;              // [QT]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int k_start = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const long q_stride = long(H) * D, kv_stride = long(KVH) * D;
  const long kv_off = (long(b) * T_len + k_start) * kv_stride + long(kvh) * D;
  load_tile<D, BK>(Ks, k + kv_off, kv_stride, T_len - k_start, tid);
  load_tile<D, BK>(Vs, v + kv_off, kv_stride, T_len - k_start, tid);

  float dk_acc[RK][AD], dv_acc[RK][AD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int a = 0; a < AD; ++a) dk_acc[i][a] = dv_acc[i][a] = 0.f;

  const int nq = (S + QT - 1) / QT;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long q_head = long(b) * S * H * D + long(h) * D;
    const long row_head = (long(b) * H + h) * S;
    for (int qi = 0; qi < nq; ++qi) {
      const int q_start = qi * QT;
      if (!tile_needed(q_start, QT, k_start, kv_len, causal, window))
        continue;
      __syncthreads();                  // the last tile's readers are done
      const long q_off = q_head + long(q_start) * q_stride;
      load_tile<D, QT>(Qs, q + q_off, q_stride, S - q_start, tid);
      load_tile<D, QT>(dOs, dout + q_off, q_stride, S - q_start, tid);
      for (int r = tid; r < QT; r += THREADS) {
        const bool in = q_start + r < S;
        rowL[r] = in ? lse[row_head + q_start + r] : 0.f;
        rowD[r] = in ? delta[row_head + q_start + r] : 0.f;
      }
      __syncthreads();

      float s[RQ][CK], dp[RQ][CK];
      product_abt<D, RQ>(s, Qs, Ks, ty, tx);     // S = Q K^T
      product_abt<D, RQ>(dp, dOs, Vs, ty, tx);   // dP = dO V^T
      p_and_ds<SOFTCAP, RQ>(s, dp, Ps, dSs, rowL, rowD, q_start, k_start, S,
                            kv_len, causal, window, softcap, scale, ty, tx);
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: this thread's keys ty*RK + i, columns
      // tx + a*TX
#pragma unroll 4
      for (int r = 0; r < QT; ++r) {
        float pv[RK], dsv[RK], dov[AD], qv[AD];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Ps[r * PS + ty * RK + i];
          dsv[i] = dSs[r * PS + ty * RK + i];
        }
#pragma unroll
        for (int a = 0; a < AD; ++a) {
          dov[a] = dOs[r * DP + tx + a * TX];
          qv[a] = Qs[r * DP + tx + a * TX];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int a = 0; a < AD; ++a) {
            dv_acc[i][a] = fmaf(pv[i], dov[a], dv_acc[i][a]);
            dk_acc[i][a] = fmaf(dsv[i], qv[a], dk_acc[i][a]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int t = k_start + ty * RK + i;
    if (t >= T_len) continue;
    const long off = (long(b) * T_len + t) * kv_stride + long(kvh) * D;
#pragma unroll
    for (int a = 0; a < AD; ++a) {
      dk[off + tx + a * TX] = dk_acc[i][a] * scale;
      dv[off + tx + a * TX] = dv_acc[i][a];
    }
  }
}

template <int D>
constexpr size_t dq_simt_smem() {
  constexpr size_t QT = simt_q_rows<D>();
  return sizeof(float) *
         (2 * QT * (D + 1) + 2 * size_t(BK) * (D + 1) + QT * PS + 2 * QT);
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int S, int T_len, int H, int KVH,
               int kv_len, int causal, int window, float softcap,
               float scale) {
  constexpr int QT = simt_q_rows<D>();
  constexpr int RQ = QT / TY;
  constexpr int DP = D + 1;
  constexpr int AD = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                     // [QT][DP]
  float* dOs = Qs + QT * DP;            // [QT][DP]
  float* Ks = dOs + QT * DP;            // [BK][DP]
  float* Vs = Ks + BK * DP;             // [BK][DP]
  float* dSs = Vs + BK * DP;            // [QT][PS]
  float* rowL = dSs + QT * PS;          // [QT]
  float* rowD = rowL + QT;              // [QT]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  // the causal q tiles with the most KV tiles start first
  const int q_start = (gridDim.x - 1 - blockIdx.x) * QT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_stride = long(H) * D, kv_stride = long(KVH) * D;
  const long q_off = (long(b) * S + q_start) * q_stride + long(h) * D;
  const long row_head = (long(b) * H + h) * S;
  load_tile<D, QT>(Qs, q + q_off, q_stride, S - q_start, tid);
  load_tile<D, QT>(dOs, dout + q_off, q_stride, S - q_start, tid);
  for (int r = tid; r < QT; r += THREADS) {
    const bool in = q_start + r < S;
    rowL[r] = in ? lse[row_head + q_start + r] : 0.f;
    rowD[r] = in ? delta[row_head + q_start + r] : 0.f;
  }

  float dq_acc[RQ][AD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int a = 0; a < AD; ++a) dq_acc[i][a] = 0.f;

  const int nk = (T_len + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    if (!tile_needed(q_start, QT, k_start, kv_len, causal, window)) continue;
    __syncthreads();                    // the last tile's readers are done
    const long kv_off =
        (long(b) * T_len + k_start) * kv_stride + long(kvh) * D;
    load_tile<D, BK>(Ks, k + kv_off, kv_stride, T_len - k_start, tid);
    load_tile<D, BK>(Vs, v + kv_off, kv_stride, T_len - k_start, tid);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
    product_abt<D, RQ>(s, Qs, Ks, ty, tx);
    product_abt<D, RQ>(dp, dOs, Vs, ty, tx);
    p_and_ds<SOFTCAP, RQ>(s, dp, nullptr, dSs, rowL, rowD, q_start, k_start,
                          S, kv_len, causal, window, softcap, scale, ty, tx);
    __syncthreads();

    // dQ += dS K: this thread's rows ty*RQ + i, columns tx + a*TX
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[RQ], kv[AD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = dSs[(ty * RQ + i) * PS + c];
#pragma unroll
      for (int a = 0; a < AD; ++a) kv[a] = Ks[c * DP + tx + a * TX];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int a = 0; a < AD; ++a)
          dq_acc[i][a] = fmaf(dsv[i], kv[a], dq_acc[i][a]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q_start + ty * RQ + i;
    if (s >= S) continue;
    const long off = (long(b) * S + s) * q_stride + long(h) * D;
#pragma unroll
    for (int a = 0; a < AD; ++a)
      dq[off + tx + a * TX] = dq_acc[i][a] * scale;
  }
}

// ------------------------------------------------------------ launching

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  int B, S, T_len, H, KVH, kv_len, causal, window;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int D, bool SOFTCAP>
cudaError_t launch(const Args& a) {
  const long rows = long(a.B) * a.S * a.H;
  fa_bwd_delta<T, D><<<unsigned((rows + DELTA_WARPS - 1) / DELTA_WARPS),
                       32 * DELTA_WARPS, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.S, a.H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 kv_grid((a.T_len + BK - 1) / BK, a.KVH, a.B);
  if constexpr (sizeof(T) == 2) {
    using bf = __nv_bfloat16;
    const auto* q = static_cast<const bf*>(a.q);
    const auto* k = static_cast<const bf*>(a.k);
    const auto* v = static_cast<const bf*>(a.v);
    const auto* dout = static_cast<const bf*>(a.dout);
    auto dkdv = fa_bwd_dkdv_wgmma<D, SOFTCAP>;
    if ((err = set_smem(dkdv, Bwd<D>::DKDV_SMEM)) != cudaSuccess) return err;
    dkdv<<<kv_grid, WG_THREADS * Bwd<D>::WGS, Bwd<D>::DKDV_SMEM, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<bf*>(a.dk),
        static_cast<bf*>(a.dv), a.S, a.T_len, a.H, a.KVH, a.kv_len, a.causal,
        a.window, a.softcap, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto dqk = fa_bwd_dq_wgmma<D, SOFTCAP>;
    if ((err = set_smem(dqk, Bwd<D>::DQ_SMEM)) != cudaSuccess) return err;
    dqk<<<dim3((a.S + BQ - 1) / BQ, a.H, a.B), WG_THREADS, Bwd<D>::DQ_SMEM,
          a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<bf*>(a.dq),
                      a.S, a.T_len, a.H, a.KVH, a.kv_len, a.causal, a.window,
                      a.softcap, a.scale);
  } else {
    const auto* q = static_cast<const float*>(a.q);
    const auto* k = static_cast<const float*>(a.k);
    const auto* v = static_cast<const float*>(a.v);
    const auto* dout = static_cast<const float*>(a.dout);
    auto dkdv = fa_bwd_dkdv_simt<D, SOFTCAP>;
    if ((err = set_smem(dkdv, dkdv_simt_smem<D>())) != cudaSuccess)
      return err;
    dkdv<<<kv_grid, THREADS, dkdv_simt_smem<D>(), a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.S, a.T_len, a.H, a.KVH, a.kv_len,
        a.causal, a.window, a.softcap, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    constexpr int QT = simt_q_rows<D>();
    auto dqk = fa_bwd_dq_simt<D, SOFTCAP>;
    if ((err = set_smem(dqk, dq_simt_smem<D>())) != cudaSuccess) return err;
    dqk<<<dim3((a.S + QT - 1) / QT, a.H, a.B), THREADS, dq_simt_smem<D>(),
          a.stream>>>(q, k, v, dout, a.lse, a.delta,
                      static_cast<float*>(a.dq), a.S, a.T_len, a.H, a.KVH,
                      a.kv_len, a.causal, a.window, a.softcap, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const Args& a) {
  return a.softcap > 0.f ? launch<T, D, true>(a) : launch<T, D, false>(a);
}

template <typename T>
int dispatch(int D, const Args& a) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(a);
    case 64:
      return launch_d<T, 64>(a);
    case 128:
      return launch_d<T, 128>(a);
    case 192:
      return launch_d<T, 192>(a);
    case 256:
      return launch_d<T, 256>(a);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o, lse, dO -> dQ, dK, dV (bf16: the wgmma kernels); delta: the
// caller's fp32 [B, H, S] workspace.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int B, int S, int T_len, int H, int KVH, int D, int kv_len,
    int causal, int window, float softcap, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(
      D, Args{q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, T_len, H, KVH,
              kv_len, causal, window, softcap, scale,
              static_cast<cudaStream_t>(stream)});
}

// The same in fp32 (the CUDA-core kernels).
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int B, int S, int T_len, int H, int KVH, int D, int kv_len,
    int causal, int window, float softcap, float scale, void* stream) {
  return dispatch<float>(
      D, Args{q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, T_len, H, KVH,
              kv_len, causal, window, softcap, scale,
              static_cast<cudaStream_t>(stream)});
}

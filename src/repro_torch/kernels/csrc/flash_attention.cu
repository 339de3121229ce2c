// Prefill attention for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_kernel (body _kernel).  Same function: causal or
// non-causal blocked online-softmax attention with GQA (query head h reads
// KV head h / G), an optional sliding window, an optional tanh logit softcap,
// and kv_len masking the tail of the keys.
//
// Layouts: q/out [B, S, H, D], k/v [B, T, KVH, D], all contiguous; bf16 or
// fp32 in, fp32 scores / m / l / acc, output in q's type.  Given an lse
// pointer (training: flash_attention_bwd.cu recomputes P from it), each
// row's log-sum-exp m + log l in natural units, fp32 [B, H, S]; the serving
// path passes NULL and writes nothing more.
//
// What bounds it on this card: for a long prompt the operations (4 * S^2/2 *
// H * D for causal attention against ~2 * S * H * D * 2 bytes of
// q/k/v/out), far above the H100's ~295 FLOP/byte ridge, so the tensor
// cores set the pace.  bf16 inputs take flash_attention_wgmma, the
// FlashAttention-2 shape on Hopper's warpgroup products:
//   * one block of one warpgroup (4 warps) per (64-row q tile, head, batch),
//     each warp owning 16 query rows.  Two blocks fit on an SM (83 KB of
//     shared memory at D = 128), so one block's softmax runs while the
//     other's products do; at D = 192 one block takes 121 KB and at
//     D = 256 161 KB, and an SM holds one (blocks_per_sm).  The q tiles launch in reverse order, so
//     the causal tiles with the most KV tiles start first;
//   * Q is copied once into shared memory with cp.async; each KV tile
//     reads it into registers again as the S product's A operand
//     (ldmatrix.x4: the mma.sync A-fragment layout, which wgmma takes from
//     registers), so no A fragment lives across tiles (see below).  K and
//     V tiles of 64 rows go through a two-stage ring by cp.async.cg,
//     zero-filled past T, in the swizzled layout that wgmma's
//     shared-memory descriptors read (128-byte swizzle at D = 128, 192 and
//     256, 64-byte below; a 192-wide row is three 128-byte blocks), so
//     tile j+1 loads while tile j is computed;
//   * S = Q K^T is wgmma m64n64k16 (K read K-major) and O += P V is wgmma
//     m64nDk16 (V read N-major; m64n192k16 at D = 192, m64n256k16 at
//     D = 256, the widest wgmma),
//     bf16 in, fp32 accumulators in registers.  P never touches shared
//     memory: the fp32 S accumulator packs pairwise into the A operand of
//     the P V product (P rounds to bf16 there, where the plain version
//     keeps it in fp32).  V's descriptor is the N-major
//     canonical layout: the leading byte offset steps between SW-byte
//     column blocks along N, the stride byte offset between 8-key groups;
//   * the online softmax runs in fp32 registers in log2 units (ex2, with
//     scale * log2(e) folded into the scores; under a softcap, tanh of the
//     scaled score over the cap, times cap * log2(e)); a row's max is reduced
//     over the 4 lanes that hold it, and its sum only once, at the end;
//   * the mask (causal, window, kv_len, ragged S and T) runs only on the KV
//     tiles that cross an edge of the band; tiles outside it are skipped
//     whole, like the TPU kernel's pl.when.  Masked scores take NEG_INF
//     before the row max, exactly as the plain version does.
// Why Q's fragments are read at every tile: loaded once and carried from
// tile to tile in registers, at D = 64 they were given the same registers
// as P's fragments (R88-R103 in ptxas's SASS), so from the second KV tile
// on S was computed from the previous tile's P (errors of 0.2-0.7 against
// the plain version).  The descriptors were not at fault:
// scripts/wgmma_probe.cu runs this P V product alone, with the kernel's
// descriptors and swizzle, and it is exact.  Now only O, the products'
// accumulator, lives across tiles in their registers.  At D = 256 a thread
// holds O (128 registers), Q's fragments (64) and S (32) at once, which
// still fits the 255 a thread may have: ptxas (sm_90a) gives 252-254 and
// no spills, so neither O += P V in two halves nor D split over two
// warpgroups is needed.  D = 192 (nemotron-4-340b's heads) is the same
// design: O takes 96 registers, Q's fragments 48.
// fp32 inputs take flash_attention_simt, on CUDA cores in fp32: the
// tensor cores would compute in TF32, which keeps about 3 digits,
// and the fp32 path is held to 2e-5.  The model runs in bf16, so the main
// path never reaches it.  Its fp32 Q, K, V and P tiles take 162 KB of
// shared memory at D = 192 and 210 KB at D = 256, under the 227 KB a block
// may have.  Both
// kernels use the plain version's 64 x 64 tiles
// (kernels/flash_attention.py), so all three visit the same tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per KV tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------ the tiles a q tile visits

// The KV tiles that touch the visible band of the q tile at q_start form
// one run [lo, hi] (hi < lo: none).  Each condition of the band is monotone
// in the tile index: k_start < kv_len and (causal) k_start <= q_end bound
// it above, (window) k_end > q_start - window below.
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

// Does every (row, key) of the tile lie inside the band, so that the tile
// needs no mask?  (Rows past S are never stored, so they do not count.)
__device__ __forceinline__ bool tile_full(int q_start, int k_start,
                                          int kv_len, int causal,
                                          int window) {
  const int k_end = k_start + BK - 1;
  bool full = k_end < kv_len;
  if (causal) full = full && k_end <= q_start;
  if (window > 0) full = full && k_start > q_start + BQ - 1 - window;
  return full;
}

// -------------------------------------------------- bf16: shared helpers

// Shared-memory row stride, in elements: 16 bytes of padding put the 8 rows
// an ldmatrix reads in 8 distinct 16-byte bank groups.
template <int D>
__host__ __device__ constexpr int q_row() { return D + 8; }

constexpr int WG_THREADS = 32 * BQ / 16;   // a warpgroup: 16 rows a warp
constexpr int STAGES = 2;                   // K/V tiles in the ring

// Copy ROWS rows of D bf16 (global row stride `stride` elements, row r at
// src + r * stride) into a [ROWS][D + 8] shared tile; rows at or past
// `valid` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long stride, int valid, int tid) {
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int RS = q_row<D>();
#pragma unroll
  for (int e = tid; e < ROWS * CH; e += WG_THREADS) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + r * RS + c * 8),
               ok ? src + r * stride + c * 8 : src, ok);
  }
}

// The online-softmax step of one 16-row x 64-key score tile held as mma
// accumulator fragments (s[n][e]: row g + 8 * (e / 2), key n * 8 + c2 +
// e % 2): scale (and softcap) into log2 units, mask if the tile crosses the
// band's edge, take the row max over the 4 lanes of a row, turn s into P
// and rescale the running m, l and O.  Masked scores take NEG_INF before
// the max, as in the plain version.
template <int D, bool SOFTCAP>
__device__ __forceinline__ void online_softmax(
    float (&s)[BK / 8][4], float (&o)[D / 8][4], float (&m)[2], float (&l)[2],
    int qrow, int k_start, int c2, int kv_len, int causal, int window,
    float qk_scale, float cap_log2, bool masked) {
  constexpr int NS = BK / 8;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * qk_scale;
      if (SOFTCAP) x = tanhf(x) * cap_log2;
      s[n][e] = x;
    }
  if (masked) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qrow + 8 * (e / 2);
        const int kpos = k_start + n * 8 + c2 + (e % 2);
        bool valid = kpos < kv_len;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        if (!valid) s[n][e] = NEG_INF;
      }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[n][e] - m[e / 2]);
      s[n][e] = p;
      l[e / 2] += p;
    }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
}

// P's A fragment for keys kk*16 + [0, 16): the accumulators of n-tiles 2kk
// and 2kk+1, packed pairwise to bf16.
__device__ __forceinline__ void p_fragment(const float (&s)[BK / 8][4],
                                           int kk, uint32_t (&pf)[4]) {
  pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// The block's output rows: the warp's 16 rows of O / l through its own rows
// of Qs, then 16-byte stores of the rows before S.  With lse_rows (the
// warp's first row of the [S] log-sum-exp row of its head; NULL: not
// asked for), each row's natural-unit log-sum-exp ln 2 * (m + log2 l), m
// and l being in log2 units here.
template <int D>
__device__ __forceinline__ void store_rows(
    float (&o)[D / 8][4], const float (&m)[2], float (&l)[2],
    __nv_bfloat16* Ow, __nv_bfloat16* __restrict__ out_rows, long stride,
    float* __restrict__ lse_rows, int valid, int lane) {
  constexpr int RS = q_row<D>();
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (lse_rows != nullptr && c == 0 && g + 8 * r < valid)
      lse_rows[g + 8 * r] = LN2 * (m[r] + log2f(l[r]));
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    __nv_bfloat16* row = Ow + g * RS + n * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(row) =
        pack_bf16(o[n][0] * l[0], o[n][1] * l[0]);
    *reinterpret_cast<uint32_t*>(row + 8 * RS) =
        pack_bf16(o[n][2] * l[1], o[n][3] * l[1]);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, ch = e % CH;
    if (r < valid)
      *reinterpret_cast<uint4*>(out_rows + r * stride + ch * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * RS + ch * 8);
  }
}

// ---------------------------------------------- bf16: warpgroup products

// K and V tiles for wgmma: [BK][D] in the swizzled layout of hopper.cuh
// (128-byte swizzle at D = 128, 192 and 256, 64-byte below).
template <int D>
using KvTile = SwTile<BK, D>;

template <int D>
constexpr size_t wgmma_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(BQ) * q_row<D>() +
         size_t(STAGES) * 2 * KvTile<D>::BYTES;
}

// Blocks an SM holds by shared memory (227 KB a block at most, 228 KB an
// SM): two up to D = 128, one at D = 192 (Q 25 KB + the K/V ring 96 KB)
// and at D = 256 (Q 33 KB + the K/V ring 128 KB).
template <int D>
constexpr int blocks_per_sm() {
  return 2 * (wgmma_smem_bytes<D>() + 1024) <= 233472 ? 2 : 1;
}

// One warpgroup per (64-row q tile, head, batch): Q's A fragments come from
// shared memory at every KV tile; K (S = Q K^T, K-major) and V (O += P V,
// N-major) are read by
// the tensor cores straight from the swizzled ring.  Around each product the
// accumulators and A fragments are pinned (fence_regs), and the products
// are waited for before their results are read.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(WG_THREADS, blocks_per_sm<D>())
flash_attention_wgmma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int S, int T_len,
                      int H, int KVH, int kv_len, int causal, int window,
                      float softcap, float scale) {
  using Tile = KvTile<D>;
  constexpr int RS = q_row<D>();
  constexpr int KB = D / 16;
  constexpr int NS = BK / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* KV = smem_raw + sizeof(__nv_bfloat16) * BQ * RS;
  // stage st: K at KV + (2 st) * BYTES, V at KV + (2 st + 1) * BYTES

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int row0 = warp * 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_stride = long(H) * D, kv_stride = long(KVH) * D;
  const __nv_bfloat16* qb = q + (long(b) * S * H + h) * D;
  const __nv_bfloat16* kb = k + (long(b) * T_len * KVH + kvh) * D;
  const __nv_bfloat16* vb = v + (long(b) * T_len * KVH + kvh) * D;
  const int a_off = ((lane % 8) + 8 * ((lane / 8) % 2)) * RS + 8 * (lane / 16);

  int lo, hi;
  band(q_start, kv_len, causal, window, &lo, &hi);
  auto issue = [&](int j) {
    if (j <= hi) {
      const int k0 = j * BK, st = (j - lo) % STAGES;
      load_sw_tile<BK, D, WG_THREADS>(KV + (2 * st) * Tile::BYTES,
                                      kb + k0 * kv_stride, kv_stride,
                                      T_len - k0, tid);
      load_sw_tile<BK, D, WG_THREADS>(KV + (2 * st + 1) * Tile::BYTES,
                                      vb + k0 * kv_stride, kv_stride,
                                      T_len - k0, tid);
    }
    cp_async_commit();
  };
  load_tile<D, BQ>(Qs, qb + q_start * q_stride, q_stride, S - q_start, tid);
  issue(lo);                         // group: Q and tile lo

  const float qk_scale = SOFTCAP ? scale / softcap : scale * LOG2E;
  const float cap_log2 = softcap * LOG2E;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int j = lo; j <= hi; ++j) {
    // tile j has landed; after the barrier tile j-1's stage is free for
    // tile j+1
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    issue(j + 1);
    const int stage = (j - lo) % STAGES;
    const uint32_t Kc = smem_addr(KV + (2 * stage) * Tile::BYTES);
    const uint32_t Vc = smem_addr(KV + (2 * stage + 1) * Tile::BYTES);

    // Q's fragments, read again at every tile: held across tiles, they
    // shared registers with P's fragments at D = 64 (see the header)
    uint32_t qf[KB][4];
    const uint32_t Qa = smem_addr(Qs + row0 * RS + a_off);
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) ldmatrix_x4(qf[kk], Qa + 2 * kk * 16);

    // S = Q K_j^T: 64 rows x 64 keys
    float s[NS][4];
    fence_regs(qf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
      wgmma_rs<0>(s, qf[kk], Tile::k_major(Kc, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(qf);

    online_softmax<D, SOFTCAP>(s, o, m, l, q_start + row0 + g, j * BK, 2 * c,
                               kv_len, causal, window, qk_scale, cap_log2,
                               !tile_full(q_start, j * BK, kv_len, causal,
                                          window));

    // P's fragments, all packed before the products: wgmma reads its A
    // registers while it runs, so they stay untouched until the wait
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) p_fragment(s, kk, pf[kk]);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<1>(o, pf[kk], Tile::n_major(Vc, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pf);
  }
  cp_async_wait<0>();                // no copy in flight (lo > hi: Q only)
  __syncthreads();
  store_rows<D>(o, m, l, Qs + row0 * RS,
                out + (long(b) * S + q_start + row0) * q_stride + long(h) * D,
                q_stride,
                lse == nullptr ? nullptr
                               : lse + (long(b) * H + h) * S + q_start + row0,
                S - q_start - row0, lane);
}

// ------------------------------------------------------ fp32: CUDA cores

constexpr int TY = 16;            // thread grid: TY x TX = 256 threads
constexpr int TX = 16;
constexpr int SIMT_THREADS = TY * TX;
constexpr int RQ = BQ / TY;       // query rows per thread
constexpr int CK = BK / TX;       // score columns per thread
constexpr int PS = BK + 4;        // P row stride: the two row groups of a
                                  // warp (RQ = 4 rows apart) land 16 banks
                                  // apart

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * PS);
}

// Q, K and V tiles in shared memory as fp32 (rows
// padded by one float so column reads are bank-conflict free), scores, m,
// l and acc in fp32 registers, natural-unit expf.
template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_attention_simt(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, int T_len, int H,
                     int KVH, int kv_len, int causal, int window,
                     float softcap, float scale) {
  constexpr int DP = D + 1;
  constexpr int AD = D / TX;      // acc columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][DP]
  float* Ks = Qs + BQ * DP;       // [BK][DP]
  float* Vs = Ks + BK * DP;       // [BK][D]
  float* Ps = Vs + BK * D;        // [BQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_row = long(H) * D;     // stride between consecutive positions
  const long kv_row = long(KVH) * D;
  const float* qb = q + (long(b) * S * H + h) * D;
  const float* kb = k + (long(b) * T_len * KVH + kvh) * D;
  const float* vb = v + (long(b) * T_len * KVH + kvh) * D;

  for (int e = tid; e < BQ * D; e += SIMT_THREADS) {
    const int r = e / D, d = e % D, s = q_start + r;
    Qs[r * DP + d] = s < S ? qb[s * q_row + d] : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][AD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int a = 0; a < AD; ++a) acc[i][a] = 0.f;
  }

  int lo, hi;
  band(q_start, kv_len, causal, window, &lo, &hi);
  for (int it = lo; it <= hi; ++it) {
    const int k_start = it * BK;
    __syncthreads();              // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += SIMT_THREADS) {
      const int c = e / D, d = e % D, t = k_start + c;
      float kx = 0.f, vx = 0.f;
      if (t < T_len) {
        kx = kb[t * kv_row + d];
        vx = vb[t * kv_row + d];
      }
      Ks[c * DP + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty * RQ + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + j * TX) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q_start + ty * RQ + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = k_start + tx + j * TX;
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        bool valid = kpos < kv_len;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        s = valid ? s : NEG_INF;
        sc[i][j] = s;
        row_max = fmaxf(row_max, s);
      }
      // the 16 lanes holding one row are one half of a warp
#pragma unroll
      for (int o = TX / 2; o > 0; o >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, o));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty * RQ + i) * PS + tx + j * TX] = p;
        row_sum += p;
      }
#pragma unroll
      for (int o = TX / 2; o > 0; o >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int a = 0; a < AD; ++a) acc[i][a] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[AD];
#pragma unroll
      for (int a = 0; a < AD; ++a) vv[a] = Vs[c * D + tx + a * TX];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = Ps[(ty * RQ + i) * PS + c];
#pragma unroll
        for (int a = 0; a < AD; ++a) acc[i][a] = fmaf(p, vv[a], acc[i][a]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q_start + ty * RQ + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(long(b) * H + h) * S + s] = m[i] + logf(l[i]);
    float* o = out + ((long(b) * S + s) * H + h) * D;
#pragma unroll
    for (int a = 0; a < AD; ++a) o[tx + a * TX] = acc[i][a] / denom;
  }
}

// ------------------------------------------------------------ launching

template <int D, bool SOFTCAP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int T_len,
                         int H, int KVH, int kv_len, int causal, int window,
                         float softcap, float scale, cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes<D>();
  auto kernel = flash_attention_wgmma<D, SOFTCAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, S, T_len, H, KVH, kv_len,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int T_len, int H, int KVH,
                   int kv_len, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return softcap > 0.f
               ? launch_wgmma<D, true>(q, k, v, out, lse, B, S, T_len, H, KVH,
                                       kv_len, causal, window, softcap,
                                       scale, stream)
               : launch_wgmma<D, false>(q, k, v, out, lse, B, S, T_len, H,
                                        KVH, kv_len, causal, window, softcap,
                                        scale, stream);
  } else {
    const size_t smem = simt_smem_bytes<D>();
    auto kernel = flash_attention_simt<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    kernel<<<grid, SIMT_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, S, T_len, H,
        KVH, kv_len, causal, window, softcap, scale);
    return cudaGetLastError();
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int S, int T_len, int H, int KVH, int D,
             int kv_len, int causal, int window, float softcap, float scale,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, S, T_len, H, KVH, kv_len,
                           causal, window, softcap, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, S, T_len, H, KVH, kv_len,
                           causal, window, softcap, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, S, T_len, H, KVH, kv_len,
                            causal, window, softcap, scale, st);
    case 192:
      return launch<T, 192>(q, k, v, out, lse, B, S, T_len, H, KVH, kv_len,
                            causal, window, softcap, scale, st);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, S, T_len, H, KVH, kv_len,
                            causal, window, softcap, scale, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16 q/k/v: the tensor-core kernel, flash_attention_wgmma.  lse: fp32
// [B, H, S], each row's log-sum-exp of its scaled (and capped) scores, for
// the backward pass; NULL (the serving path) writes none.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int B, int S, int T_len, int H, int KVH,
                                    int D, int kv_len, int causal,
                                    int window, float softcap, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, lse, B, S, T_len, H, KVH, D,
                                 kv_len, causal, window, softcap, scale,
                                 stream);
}

// fp32 q/k/v: the CUDA-core kernel, flash_attention_simt (lse as above).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int S, int T_len, int H, int KVH,
                                   int D, int kv_len, int causal, int window,
                                   float softcap, float scale, void* stream) {
  return dispatch<float>(q, k, v, out, lse, B, S, T_len, H, KVH, D, kv_len,
                         causal, window, softcap, scale, stream);
}

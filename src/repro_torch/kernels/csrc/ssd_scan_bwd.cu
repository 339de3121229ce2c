// The backward pass of the Mamba-2 SSD chunked scan for Hopper (sm_90a),
// written by hand.
//
// No TPU kernel is replaced: the Pallas scan (repro/kernels/ssd_scan.py) has
// no backward, and the JAX model trains through ssd_chunked
// (src/repro/models/mamba2.py:79), which XLA differentiates.  This computes
// the same gradient of the function ssd_scan.cu computes.  Per chunk of Q
// rows and head, with cum_i = sum_{k<=i} dt_k A, S_{c-1} the state before
// the chunk, S_c the state after it and G_c the gradient of S_c (G_{nc-1}
// the final state's gradient):
//   G_{c-1} = exp(cum_last) G_c + sum_i exp(cum_i) dy_i C_i^T, dinit = G_{-1}
//   br_j    = sum_{i>=j} (C_i . B_j) exp(cum_i - cum_j) dy_i
//             + exp(cum_last - cum_j) G_c B_j
//   dx_j    = dt_j br_j,   ddt_j = x_j . br_j + A sum_{i>=j} dcum_i
//   dB_j    = sum_{i>=j} exp(cum_i - cum_j) dt_j (dy_i . x_j) C_i
//             + exp(cum_last - cum_j) dt_j G_c^T x_j       (summed over the
//   dC_i    = exp(cum_i) S_{c-1}^T dy_i                     heads of a group)
//             + sum_{j<=i} exp(cum_i - cum_j) dt_j (dy_i . x_j) B_j
//   dA      = sum over rows of dt_k sum_{i>=k} dcum_i
// dcum_i, the gradient of cum_i, is the sum of the terms that
// kernels/ssd_scan.py:ssd_scan_bwd_plain writes out (the products M_ij and
// the state terms); here it comes from two dot products a row, which add up
// to the same:
//   dcum_i = dy_i . y_i - dt_i (x_i . br_i),  the last row + <G_c, S_c>,
// y_i the forward's output (before the D skip) in fp32: dy_i . y_i sums
// row i's M_ij and its state term, dt_i x_i . br_i the M_ji of column i and
// the k_i of the state, and <G_c, S_c> the last row's extra terms.  The
// rows pass writes dy_i . y_i and x_i . br_i (in ddt), the reduce pass
// forms dcum from them.
//
// Layouts as the forward's (ssd_scan.cu): x/dy/dx [B, S, H, P] and
// Bm/Cm/dB/dC [B, S, G, N] in bf16 or fp32 (all the same type), dt/ddt
// [B, S, H] fp32, A/dA [H] fp32, initial state/final state's gradient/dinit
// [B, H, P, N] fp32; all contiguous.  The workspace (fp32, from the caller,
// one per call; kernels/ssd_scan.py:bwd_workspace_floats sizes it, struct
// Workspace below lays it out) holds the chunk states and their gradients,
// the partials of dB and dC, cum, dy . y and <G_c, S_c>.
//
// Four passes on the current stream, one writer for every element and no
// atomics, so the result does not change from run to run:
//   1. chunk, one block per (chunk, head, batch) and product: cum (one
//      warp's scan of dt * A), the chunk's own state
//      dS_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T and its dy term
//      E_c = sum_i exp(cum_i) dy_i C_i^T, [P x Q] by [Q x N] products;
//   2. state (ssd_bwd_state), elementwise over [P, N], one float4 a
//      thread (state_split blocks a batch and head), and sequential over
//      the chunks: forward from the initial state,
//      S_c = exp(cum_last) S_{c-1} + dS_c; back from the final state's
//      gradient, G_{c-1} = exp(cum_last) G_c + E_c, and each block's part
//      of <G_c, S_c> summed in a fixed order;
//   3. rows, over the 64-row tiles of each chunk: as rows i, dC_i (the
//      state term, then the tiles j <= i) and dy_i . y_i; as rows j, br_j
//      and dB_j (the state terms, then the tiles i >= j), then dx_j and
//      ddt's direct part x_j . br_j;
//   4. reduce (ssd_bwd_reduce), blocks of 32 warps: H blocks, one per
//      head, each warp taking whole chunks: dcum's reverse cumsum (the last
//      row plus <G_c, S_c>, its partials summed in order), ddt += A ddA,
//      and dA summed per warp, then over the warps in order; the other
//      blocks sum dB's and dC's partials over each group and cast them to
//      the inputs' type.
//
// What bounds it: operations.  A chunk and head take about
// Q (Q + 1)(3 N + 2 P) + 10 Q N P operations, far above the card's ridge.
//
// bf16 (the model's type, the training path) runs every product on the
// tensor cores (wgmma, hopper.cuh), as the forward does:
//   * the chunk pass is the forward's ssd_chunk_state with a second
//     product (chunk_state_product, ssd_common.cuh): the weighted rows of x
//     or dy split into bf16 high and low parts as the A operand, B or C
//     exact, every state column in one block;
//   * the state pass also writes S_{c-1} and G_c as bf16 high and low
//     tiles in the swizzled layout of SwTile<P, N>, which the rows pass
//     copies into shared memory as they are, as the forward's state pass
//     does for its S_{c-1};
//   * the rows pass is two launches of one warpgroup a block:
//     ssd_bwd_rows_i for the rows as i and ssd_bwd_rows_j for the rows as
//     j.  Both score products of a tile pair read their two operands from
//     swizzled shared memory (wgmma_ss): C_i B_j^T and dy_i x_j^T in the
//     i-role, the transposes B_j C_i^T and x_j dy_i^T in the j-role, as
//     flash's dK/dV block makes K Q^T.  The decay-masked weights are made
//     in fp32 in the accumulators' layout and packed, split into high and
//     low parts, as A fragments that feed the next products from registers
//     (wgmma_rs, B N-major): dC_i += W B_j; br_j += (S o L)^T dy_i and
//     dB_j += W^T C_i.  So no weight tile goes through shared memory, and
//     no A fragment lives across tiles.  The state terms read S_{c-1} and
//     G_c from their tiles, G_c both K-major (B_j G_c^T) and N-major
//     (x_j G_c).  The other tiles stream through a two-stage cp.async
//     ring.  Each block takes up to eight heads of one group in turn
//     (heads_per_block), summing their dB_j or dC_i in its registers:
//     the partials that the reduce pass reads fall eightfold at
//     mamba2-780m's 48 heads a group, and the block loads its own B_j or
//     C_i once for all of them.  The two roles keep separate blocks,
//     and each tile pair's two score products are made twice, once in
//     each role: a block holds one role's accumulators (dC_i 64 x N; br_j
//     64 x P and dB_j 64 x N; the j-role spills 20 bytes at mamba2-780m's
//     widths), and C_i B_j^T is not shared across the group's heads, which
//     would need each head's br_j at once.
//   Each product takes x, B, C and dy exactly as they arrive and splits
//   its other, fp32 operand (the weighted rows, S_{c-1}, G_c, the weights)
//   into a bf16 high part and the bf16 low part of what is left: two
//   products into one fp32 accumulator, about 16 bits of mantissa.  The
//   low parts stay: with the weights' high parts alone dA failed its bound
//   on the card by far (dcum = dy . y - dt x . br cancels, and only br saw
//   the rounding), though the CPU emulation of that rounding through the
//   plain formulas (tests/test_torch_ssd_bwd.py) stays inside it.  dt,
//   the decays and the masks stay fp32 and
//   go into the split operand or into row scales of an accumulator; the
//   states, their gradients and the cancelling dcum stay fp32 throughout.
//   No wgmma is issued under a condition (ptxas fences those): the loops
//   over heads and tiles have runtime bounds and the mask is a select.
//   The exps run on the special-function unit (exp_sfu), on differences
//   of cums taken in natural units.
// On the card (chip_smoke.py; an H100 80GB HBM3 at 700 W), at
// mamba2-780m's training shape (x/dy [4, 2048, 48, 64] bf16, N 128, chunk
// 256) the bf16 backward takes 0.82 ms on the device against 6.33 ms for
// the first version, all on CUDA cores: 10.4 % of its 0.085 ms bound.  By
// pass: chunk 0.11, state 0.15, rows 0.51 (0.22 as i, 0.29 as j), reduce
// 0.05 ms.  What still holds it back: the rows pass does 2.3 times the
// bound's operations (every weight and state split in two, the score
// products made in both roles) at about a third of the tensor cores'
// peak, since each product is waited on before the elementwise work that
// feeds the next, with two warpgroups an SM (255 registers in the j-role,
// 106 KB of shared memory); and each head's tiles load before its first
// product with nothing to overlap them.  The state pass moves its bytes
// (dS_c and E_c in, S_{c-1} in place and back, both states' tiles out)
// at about 70 % of the card's memory rate.
// fp32 keeps the CUDA-core kernels of the first version (ssd_bwd_chunk_simt,
// ssd_bwd_rows_simt): on the tensor cores fp32 would run in TF32, and the
// fp32 path is held to 1e-4.  They make every product in fp32 as a register
// tile of a 16 x 16 thread grid over operands in shared memory, rows padded
// by one 32-bit word so that the transposed reads fall on distinct banks;
// one rows block takes one head, and dy . y comes from it too.
//
// Above the diagonal cum_i - cum_j > 0 (A < 0, dt >= 0), so the mask is
// applied before the exp, as in the forward; the ragged tail and rows past
// the chunk are zero with dt = 0, so they add nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;      // fp32: a 16 x 16 grid of threads
constexpr int SLICE = 64;         // rows of a slice in ssd_bwd_chunk_simt
constexpr int WG = 128;           // bf16: a warpgroup
constexpr int TILE = 64;          // rows of a tile: wgmma's M
constexpr int RED_THREADS = 1024; // the reduce pass: a warp a chunk
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Elements of a row of D values in shared memory: one 32-bit word more than
// D, so that rows j = tx + 16 b read at one column fall on distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D + 4 / int(sizeof(T));
}

// n_valid of TR rows of D values (global row stride ld elements) into
// shared memory; rows past n_valid are zero.  32-bit words: D is even.
template <typename T, int D, int TR>
__device__ void load_rows(T* dst, const T* src, long ld, int n_valid,
                          int tid) {
  constexpr int V = 4 / int(sizeof(T)), W = D / V, SD = row_stride<T, D>();
  for (int e = tid; e < TR * W; e += THREADS) {
    const int r = e / W, w = e % W;
    uint32_t v = 0u;
    if (r < n_valid)
      v = *reinterpret_cast<const uint32_t*>(src + r * ld + w * V);
    *reinterpret_cast<uint32_t*>(dst + r * SD + w * V) = v;
  }
}

// acc[a][b] += sum_{k < K} fa(ty + 16 a, k) fb(k, tx + 16 b): a register
// tile of one thread of the 16 x 16 grid.
template <int RM, int RN, typename FA, typename FB>
__device__ __forceinline__ void mm_acc(float (&acc)[RM][RN], int K, int ty,
                                       int tx, FA fa, FB fb) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = fa(ty + 16 * i, k);
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = fb(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

// The sum of v over the 16 threads of a row of the grid (lanes 0-15 or
// 16-31 of a warp), in a fixed order.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------- 1. chunk, fp32 (SIMT)

template <typename T, int P, int N>
struct ChunkSmem {
  static constexpr int SP = row_stride<T, P>(), SN = row_stride<T, N>();
  static constexpr int X_OFF = 2 * MAX_Q * 4;             // cum, weights
  static constexpr int Y_OFF = X_OFF + ceil_div(SLICE * SP * int(sizeof(T)),
                                                16) * 16;
  static constexpr int BYTES = Y_OFF + SLICE * SN * int(sizeof(T));
};

// out[p][n] = sum_j wt_j u_j[p] v_j[n] over the chunk's rows, 64-row slices
// of u (P wide) and v (N wide) staged in shared memory.
template <typename T, int P, int N>
__device__ void chunk_product(float* out, const float* wt, const T* u,
                              const T* v, long ldu, long ldv, int rows,
                              T* Us, T* Vs, int tid) {
  using L = ChunkSmem<T, P, N>;
  constexpr int SP = L::SP, SN = L::SN;
  const int ty = tid / 16, tx = tid % 16;
  float acc[P / 16][N / 16];
  zero(acc);
  for (int k0 = 0; k0 < rows; k0 += SLICE) {
    __syncthreads();                         // the last slice is consumed
    load_rows<T, P, SLICE>(Us, u + k0 * ldu, ldu, rows - k0, tid);
    load_rows<T, N, SLICE>(Vs, v + k0 * ldv, ldv, rows - k0, tid);
    __syncthreads();
    mm_acc(acc, SLICE, ty, tx,
           [&](int p, int k) { return wt[k0 + k] * to_f(Us[k * SP + p]); },
           [&](int k, int n) { return to_f(Vs[k * SN + n]); });
  }
#pragma unroll
  for (int a = 0; a < P / 16; ++a)
#pragma unroll
    for (int b = 0; b < N / 16; ++b)
      out[(ty + 16 * a) * N + tx + 16 * b] = acc[a][b];
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_simt(const T* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ A, const T* __restrict__ Bm,
          const T* __restrict__ Cm, const T* __restrict__ dy,
          float* __restrict__ states, float* __restrict__ grads,
          float* __restrict__ cum_ws, int S, int H, int G, int Q) {
  using L = ChunkSmem<T, P, N>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cum = reinterpret_cast<float*>(smem);             // [MAX_Q]
  float* wt = cum + MAX_Q;                                 // [MAX_Q]
  T* Us = reinterpret_cast<T*>(smem + L::X_OFF);
  T* Vs = reinterpret_cast<T*>(smem + L::Y_OFF);
  const int tid = threadIdx.x, lane = tid % 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * Q, rows = min(Q, S - t0), qs = ceil_div(Q, 32) * 32;
  const float a_h = A[h];
  for (int r = tid; r < MAX_Q; r += THREADS) {
    const float d = r < rows ? dt[(long(b) * S + t0 + r) * H + h] : 0.f;
    cum[r] = d * a_h;
    wt[r] = d;
  }
  __syncthreads();
  if (tid < 32) warp_scan(cum, qs, lane);
  __syncthreads();
  const float last = cum[qs - 1];          // dt = 0 past `rows`
  const long slot = (long(b) * H + h) * nc + c;
  for (int r = tid; r < MAX_Q; r += THREADS) {
    if (r < Q) cum_ws[slot * Q + r] = cum[r];
    wt[r] *= expf(last - cum[r]);          // <= 1: cum falls along the chunk
  }
  const long x_row = long(H) * P, bc_row = long(G) * N;
  const long xoff = (long(b) * S + t0) * H + h;
  const long goff = (long(b) * S + t0) * G + h / (H / G);
  // dS_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
  chunk_product<T, P, N>(states + slot * P * N, wt, x + xoff * P,
                         Bm + goff * N, x_row, bc_row, rows, Us, Vs, tid);
  __syncthreads();
  for (int r = tid; r < MAX_Q; r += THREADS) wt[r] = expf(cum[r]);
  // E_c = sum_i exp(cum_i) dy_i C_i^T
  chunk_product<T, P, N>(grads + slot * P * N, wt, dy + xoff * P,
                         Cm + goff * N, x_row, bc_row, rows, Us, Vs, tid);
}

// ---------------------------------------------------------- 2. state

// 4 consecutive values (p, n..n+3) of a [P, N] state, split into bf16 high
// and low parts, into the tiles' swizzled layout (SwTile<P, N>: the high
// tile, then the low one), as the forward's ssd_state_pass writes S_{c-1}.
template <int P, int N>
__device__ __forceinline__ void store_split(unsigned char* tiles, int e,
                                            float4 v) {
  using ST = SwTile<P, N>;
  const int off = ST::offset(e / N, (e % N) / 8) + (e % 8) * 2;
  uint2 hi, lo;
  split_bf16(v.x, v.y, hi.x, lo.x);
  split_bf16(v.z, v.w, hi.y, lo.y);
  *reinterpret_cast<uint2*>(tiles + off) = hi;
  *reinterpret_cast<uint2*>(tiles + ST::BYTES + off) = lo;
}

// Blocks of the state pass a (batch, head): one float4 of [P, N] a thread,
// so that enough blocks walk the chunks at once to hide each step's load
// (kernels/ssd_scan.py:bwd_state_split sizes the partials of <G_c, S_c>
// by it).
template <int P, int N>
__host__ __device__ constexpr int state_split() {
  return P * N / 4 > THREADS ? P * N / 4 / THREADS : 1;
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state(float* __restrict__ states, float* __restrict__ grads,
          const float* __restrict__ cum_ws, const float* __restrict__ init,
          const float* __restrict__ dfinal, float* __restrict__ dinit,
          float* __restrict__ extra, unsigned char* __restrict__ s_tiles,
          unsigned char* __restrict__ g_tiles, int Q, int nc) {
  constexpr int PN = P * N, SPLIT = state_split<P, N>();
  constexpr int PN4 = PN / 4, SPAN = PN4 / SPLIT;
  constexpr int PER = ceil_div(SPAN, THREADS);
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x, i0 = blockIdx.y * SPAN;
  const long bh = blockIdx.x;
  float4* st = reinterpret_cast<float4*>(states + bh * nc * PN);
  float4* gr = reinterpret_cast<float4*>(grads + bh * nc * PN);
  // the caller's tensors (init, dfinal, dinit): no alignment assumed
  auto load4 = [&](const float* t, int i) {
    if (t == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p = t + bh * PN + 4 * i;
    return make_float4(p[0], p[1], p[2], p[3]);
  };
  float4 s[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = i0 + tid + k * THREADS;
    s[k] = tid + k * THREADS < SPAN ? load4(init, i)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // forward: each dS_c's slot takes S_{c-1}; s ends as the final state
  for (int c = 0; c < nc; ++c) {
    const float decay = expf(cum_ws[(bh * nc + c) * Q + Q - 1]);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = i0 + tid + k * THREADS;
      if (tid + k * THREADS >= SPAN) continue;
      const float4 d = st[c * PN4 + i];
      st[c * PN4 + i] = s[k];
      s[k] = make_float4(fmaf(decay, s[k].x, d.x), fmaf(decay, s[k].y, d.y),
                         fmaf(decay, s[k].z, d.z), fmaf(decay, s[k].w, d.w));
    }
  }
  // back: each E_c's slot takes G_c (bf16: G_c and S_{c-1} go to their
  // high and low tiles instead); s walks back from S_{nc-1}
  float4 g[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = i0 + tid + k * THREADS;
    g[k] = tid + k * THREADS < SPAN ? load4(dfinal, i)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  constexpr long TILES = 2 * SwTile<P, N>::BYTES;   // hi and lo, a slot
  for (int c = nc - 1; c >= 0; --c) {
    const float decay = expf(cum_ws[(bh * nc + c) * Q + Q - 1]);
    float part = 0.f;                       // <G_c, S_c>, this thread's
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = i0 + tid + k * THREADS;
      if (tid + k * THREADS >= SPAN) continue;
      part += g[k].x * s[k].x + g[k].y * s[k].y + g[k].z * s[k].z +
              g[k].w * s[k].w;
      const float4 e = gr[c * PN4 + i];
      s[k] = st[c * PN4 + i];               // S_{c-1}
      if (g_tiles != nullptr) {             // bf16: the rows pass's operands
        store_split<P, N>(g_tiles + (bh * nc + c) * TILES, 4 * i, g[k]);
        store_split<P, N>(s_tiles + (bh * nc + c) * TILES, 4 * i, s[k]);
      } else {
        gr[c * PN4 + i] = g[k];
      }
      g[k] = make_float4(fmaf(decay, g[k].x, e.x), fmaf(decay, g[k].y, e.y),
                         fmaf(decay, g[k].z, e.z), fmaf(decay, g[k].w, e.w));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (tid % 32 == 0) red[tid / 32] = part;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) sum += red[w];
      extra[(bh * nc + c) * SPLIT + blockIdx.y] = sum;
    }
    __syncthreads();
  }
  if (dinit != nullptr) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = i0 + tid + k * THREADS;
      if (tid + k * THREADS >= SPAN) continue;
      float* p = dinit + bh * PN + 4 * i;
      p[0] = g[k].x;
      p[1] = g[k].y;
      p[2] = g[k].z;
      p[3] = g[k].w;
    }
  }
}

// -------------------------------------------------- 3. rows, fp32 (SIMT)

// Step 3's shared memory: the block's own TR rows of x, dy, B and C; then
// either the state (S_{c-1} or G_c, fp32 [P][N + 1]) or another tile's two
// operands (x and B, or dy and C) with the tile pair's two [TR x TR + 1]
// fp32 weight tiles; cum and dt of the chunk's rows.  TR is 64 where that
// fits in 113 KB (two blocks an SM), else 32.
template <typename T, int P, int N, int TR>
struct RowsLayout {
  static constexpr int SP = row_stride<T, P>(), SN = row_stride<T, N>();
  static constexpr int TS = int(sizeof(T)), WS = TR + 1;
  static constexpr int OWN = 2 * TR * (SP + SN) * TS;
  static constexpr int OTHER = ceil_div(TR * (SP + SN) * TS, 16) * 16;
  static constexpr int PAIR = OTHER + 2 * TR * WS * 4;
  static constexpr int STATE = P * (N + 1) * 4;
  static constexpr int U_OFF = ceil_div(OWN, 16) * 16;
  static constexpr int U_BYTES = ceil_div(PAIR > STATE ? PAIR : STATE, 16) * 16;
  static constexpr int CUM_OFF = U_OFF + U_BYTES;
  static constexpr int BYTES = CUM_OFF + 2 * MAX_Q * 4;
};

template <typename T, int P, int N>
__host__ __device__ constexpr int rows_tile() {
  return RowsLayout<T, P, N, 64>::BYTES <= 113 * 1024 ? 64 : 32;
}

template <typename T, int P, int N>
using RowsSmem = RowsLayout<T, P, N, rows_tile<T, P, N>()>;

// Stage a [P, N] fp32 state (global, contiguous) into shared memory with
// rows of N + 1.
template <int P, int N>
__device__ void stage_state(float* dst, const float* src, int tid) {
  for (int e = tid; e < P * N; e += THREADS)
    dst[(e / N) * (N + 1) + e % N] = src[e];
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_rows_simt(const T* __restrict__ x, const float* __restrict__ dt,
         const T* __restrict__ Bm, const T* __restrict__ Cm,
         const T* __restrict__ dy, const float* __restrict__ states,
         const float* __restrict__ grads, const float* __restrict__ cum_ws,
         T* __restrict__ dx, float* __restrict__ ddt,
         float* __restrict__ rowd_ws, float* __restrict__ dBp,
         float* __restrict__ dCp, int S, int H, int G, int Q) {
  using L = RowsSmem<T, P, N>;
  constexpr int TR = rows_tile<T, P, N>(), RM = TR / 16;
  constexpr int SP = L::SP, SN = L::SN, WS = L::WS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Xo = reinterpret_cast<T*>(smem);      // own rows: x, dy (SP), B, C (SN)
  T* DYo = Xo + TR * SP;
  T* Bo = DYo + TR * SP;
  T* Co = Bo + TR * SN;
  unsigned char* U = smem + L::U_OFF;
  float* st = reinterpret_cast<float*>(U);             // [P][N + 1]
  T* X2 = reinterpret_cast<T*>(U);                     // another tile: SP
  T* Y2 = X2 + TR * SP;                                //   and SN wide
  float* Ssc = reinterpret_cast<float*>(U + L::OTHER);  // [TR][TR + 1]
  float* Wsc = Ssc + TR * WS;
  float* cum = reinterpret_cast<float*>(smem + L::CUM_OFF);
  float* dtv = cum + MAX_Q;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nt = ceil_div(Q, TR), nc = gridDim.x / nt;
  const int c = blockIdx.x / nt, t = blockIdx.x % nt;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, rows = min(Q, S - t0), r0 = t * TR;
  const long slot = (long(b) * H + h) * nc + c;
  for (int r = tid; r < nt * TR; r += THREADS) {
    cum[r] = cum_ws[slot * Q + min(r, Q - 1)];
    dtv[r] = r < rows ? dt[(long(b) * S + t0 + r) * H + h] : 0.f;
  }
  const long x_row = long(H) * P, bc_row = long(G) * N;
  const T* xh = x + ((long(b) * S + t0) * H + h) * P;
  const T* dyh = dy + ((long(b) * S + t0) * H + h) * P;
  const long goff = (long(b) * S + t0) * G + h / (H / G);
  const T* Bg = Bm + goff * N;
  const T* Cg = Cm + goff * N;
  auto n_valid = [&](int u) { return max(0, min(TR, rows - u * TR)); };
  load_rows<T, P, TR>(Xo, xh + r0 * x_row, x_row, n_valid(t), tid);
  load_rows<T, P, TR>(DYo, dyh + r0 * x_row, x_row, n_valid(t), tid);
  load_rows<T, N, TR>(Bo, Bg + r0 * bc_row, bc_row, n_valid(t), tid);
  load_rows<T, N, TR>(Co, Cg + r0 * bc_row, bc_row, n_valid(t), tid);
  stage_state<P, N>(st, states + slot * P * N, tid);    // S_{c-1}
  __syncthreads();
  const float last = cum[Q - 1];

  // -- the own rows as i: dC_i and dy_i . y_i
  float accC[RM][N / 16], rowd[RM];
  zero(accC);
  mm_acc(accC, P, ty, tx, [&](int i, int k) { return to_f(DYo[i * SP + k]); },
         [&](int k, int n) { return st[k * (N + 1) + n]; });
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = ty + 16 * a;
    const float e = expf(cum[r0 + i]);
    rowd[a] = 0.f;
#pragma unroll
    for (int q = 0; q < N / 16; ++q) {
      accC[a][q] *= e;
      rowd[a] += accC[a][q] * to_f(Co[i * SN + tx + 16 * q]);
    }
  }
  for (int u = 0; u <= t; ++u) {
    __syncthreads();                        // st or the last tile is read
    load_rows<T, P, TR>(X2, xh + u * TR * x_row, x_row, n_valid(u), tid);
    load_rows<T, N, TR>(Y2, Bg + u * TR * bc_row, bc_row, n_valid(u), tid);
    __syncthreads();
    float s[RM][RM], d[RM][RM];             // rows i own, columns j of u
    zero(s);
    zero(d);
    mm_acc(s, N, ty, tx, [&](int i, int k) { return to_f(Co[i * SN + k]); },
           [&](int k, int j) { return to_f(Y2[j * SN + k]); });
    mm_acc(d, P, ty, tx, [&](int i, int k) { return to_f(DYo[i * SP + k]); },
           [&](int k, int j) { return to_f(X2[j * SP + k]); });
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        const int i = ty + 16 * a, j = tx + 16 * q;
        const int gi = r0 + i, gj = u * TR + j;
        // the mask before the exp: above the diagonal it would overflow
        const float w =
            gj <= gi ? expf(cum[gi] - cum[gj]) * dtv[gj] * d[a][q] : 0.f;
        Wsc[i * WS + j] = w;
        rowd[a] += s[a][q] * w;
      }
    __syncthreads();
    mm_acc(accC, TR, ty, tx, [&](int i, int k) { return Wsc[i * WS + k]; },
           [&](int k, int n) { return to_f(Y2[k * SN + n]); });
  }
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = ty + 16 * a;
    rowd[a] = row_sum(rowd[a]);
    if (i >= n_valid(t)) continue;
    float* out = dCp + ((long(b) * S + t0 + r0 + i) * H + h) * N;
#pragma unroll
    for (int q = 0; q < N / 16; ++q) out[tx + 16 * q] = accC[a][q];
  }

  // -- the own rows as j: br_j, then dx_j, ddt's direct part, dB_j
  float accR[RM][P / 16], accB[RM][N / 16];
  zero(accR);
  zero(accB);
  __syncthreads();                          // the last tile is read
  stage_state<P, N>(st, grads + slot * P * N, tid);     // G_c
  __syncthreads();
  mm_acc(accR, N, ty, tx, [&](int j, int k) { return to_f(Bo[j * SN + k]); },
         [&](int k, int p) { return st[p * (N + 1) + k]; });
  mm_acc(accB, P, ty, tx, [&](int j, int k) { return to_f(Xo[j * SP + k]); },
         [&](int k, int n) { return st[k * (N + 1) + n]; });
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int j = r0 + ty + 16 * a;
    const float w = expf(last - cum[j]);
#pragma unroll
    for (int q = 0; q < P / 16; ++q) accR[a][q] *= w;
#pragma unroll
    for (int q = 0; q < N / 16; ++q) accB[a][q] *= w * dtv[j];
  }
  for (int u = t; u < nt; ++u) {
    __syncthreads();
    load_rows<T, P, TR>(X2, dyh + u * TR * x_row, x_row, n_valid(u), tid);
    load_rows<T, N, TR>(Y2, Cg + u * TR * bc_row, bc_row, n_valid(u), tid);
    __syncthreads();
    float s[RM][RM], d[RM][RM];             // rows i of u, columns j own
    zero(s);
    zero(d);
    mm_acc(s, N, ty, tx, [&](int i, int k) { return to_f(Y2[i * SN + k]); },
           [&](int k, int j) { return to_f(Bo[j * SN + k]); });
    mm_acc(d, P, ty, tx, [&](int i, int k) { return to_f(X2[i * SP + k]); },
           [&](int k, int j) { return to_f(Xo[j * SP + k]); });
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        const int i = ty + 16 * a, j = tx + 16 * q;
        const int gi = u * TR + i, gj = r0 + j;
        const float l = gi >= gj ? expf(cum[gi] - cum[gj]) : 0.f;
        Ssc[i * WS + j] = s[a][q] * l;
        Wsc[i * WS + j] = l * dtv[gj] * d[a][q];
      }
    __syncthreads();
    mm_acc(accR, TR, ty, tx, [&](int j, int k) { return Ssc[k * WS + j]; },
           [&](int k, int p) { return to_f(X2[k * SP + p]); });
    mm_acc(accB, TR, ty, tx, [&](int j, int k) { return Wsc[k * WS + j]; },
           [&](int k, int n) { return to_f(Y2[k * SN + n]); });
  }
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int j = ty + 16 * a, gj = r0 + j;
    float xb = 0.f;
#pragma unroll
    for (int q = 0; q < P / 16; ++q)
      xb += to_f(Xo[j * SP + tx + 16 * q]) * accR[a][q];
    xb = row_sum(xb);
    if (j >= n_valid(t)) continue;
    if (tx == 0) rowd_ws[slot * Q + gj] = rowd[a];
    const long row = (long(b) * S + t0 + gj) * H + h;
    if (tx == 0) ddt[row] = xb;
#pragma unroll
    for (int q = 0; q < P / 16; ++q)
      dx[row * P + tx + 16 * q] = from_f<T>(dtv[gj] * accR[a][q]);
    float* out = dBp + row * N;
#pragma unroll
    for (int q = 0; q < N / 16; ++q) out[tx + 16 * q] = accB[a][q];
  }
}

// ------------------------------------------- bf16: the tensor cores (wgmma)

// The bf16 chunk pass's shared memory: v's N columns (B or C) as an
// N-major swizzled tile, u's rows (x or dy) padded for scalar reads, cum and
// the row weights.
template <int P, int N>
struct ChunkWgSmem {
  using VT = SwTile<MAX_Q, N>;
  static constexpr int XS = P + 8;                 // u's row stride, elements
  static constexpr int U_OFF = VT::BYTES;
  static constexpr int CUM_OFF = U_OFF + MAX_Q * XS * 2;
  static constexpr int BYTES = CUM_OFF + 2 * MAX_Q * 4;
};

// 1. The chunk pass in bf16: one warpgroup per (chunk and product, head,
// batch), the forward's ssd_chunk_state with a second product and every
// state column in one block (the forward splits them, for more blocks;
// here u's rows and the weights would be loaded and split once a block
// for half the work).  Product 0 is
// dS_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T, product 1
// E_c = sum_i exp(cum_i) dy_i C_i^T: each the weighted rows of x or dy,
// split into bf16 high and low parts, times B or C, exact
// (chunk_state_product).  The first block of a chunk writes its cum.
template <int P, int N>
__global__ void __launch_bounds__(WG)
ssd_bwd_chunk_wgmma(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                    float* __restrict__ states, float* __restrict__ grads,
                    float* __restrict__ cum_ws, int S, int H, int G, int Q) {
  using L = ChunkWgSmem<P, N>;
  using VT = typename L::VT;
  constexpr int XS = L::XS;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Vs = smem;
  bf16* Us = reinterpret_cast<bf16*>(smem + L::U_OFF);
  float* cum = reinterpret_cast<float*>(smem + L::CUM_OFF);    // [MAX_Q]
  float* wts = cum + MAX_Q;                                    // [MAX_Q]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nc = gridDim.x / 2, c = blockIdx.x / 2, prod = blockIdx.x % 2;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const int kq = round_up(rows, 64);         // whole groups of four k-steps
  const long x_row = long(H) * P, bc_row = long(G) * N;
  const bf16* ub = (prod ? dy : x) + ((long(b) * S + t0) * H + h) * P;
  const bf16* vb =
      (prod ? Cm : Bm) + ((long(b) * S + t0) * G + h / (H / G)) * N;

  const int qs = round_up(Q, 64);            // >= kq; at most 2 WG
  const float a_h = A[h];
  float d_own[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tid + i * WG;
    d_own[i] = r < rows ? dt[(long(b) * S + t0 + r) * H + h] : 0.f;
  }
  // v and u rows [0, kq), zero at and past `rows`
  for (int e = tid; e < kq * (N / 8); e += WG) {
    const int r = e / (N / 8), ch = e % (N / 8);
    const bool ok = r < rows;
    cp_async16(smem_addr(Vs + VT::offset(r, ch)),
               ok ? vb + r * bc_row + ch * 8 : vb, ok);
  }
  for (int e = tid; e < kq * (P / 8); e += WG) {
    const int r = e / (P / 8), ch = e % (P / 8);
    const bool ok = r < rows;
    cp_async16(smem_addr(Us + r * XS + ch * 8),
               ok ? ub + r * x_row + ch * 8 : ub, ok);
  }
  cp_async_commit();

  // cum, the prefix sum of dt * A: dt = 0 past `rows`, so the rows there
  // hold cum_last and weigh nothing
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tid + i * WG;
    if (r < qs) {
      wts[r] = d_own[i];
      cum[r] = d_own[i] * a_h;
    }
  }
  __syncthreads();
  if (warp == 0) warp_scan(cum, qs, lane);
  __syncthreads();
  const float last = cum[qs - 1];
  const long slot = (long(b) * H + h) * nc + c;
  for (int r = tid; r < qs; r += WG) {
    if (r < Q && prod == 0) cum_ws[slot * Q + r] = cum[r];
    // dS_c's weights are <= 1 (cum falls along the chunk), E_c's too
    wts[r] = prod ? expf(cum[r]) : expf(last - cum[r]) * wts[r];
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  chunk_state_product<P, N, N, XS>(Us, wts, smem_addr(Vs), kq,
                                   (prod ? grads : states) + slot * P * N);
}

// The rows passes' shared memory (bf16).  Each block keeps its own tile's
// two operands (C_i and dy_i as rows i; B_j and x_j as rows j), the state
// it multiplies (S_{c-1} or G_c) as high and low tiles, a two-stage ring
// of the other tiles' two operands (B_j and x_j; C_i and dy_i), and cum and
// dt of the chunk's rows: 106 KB at mamba2-780m's P 64 and N 128, two
// blocks an SM; 210 KB at P = N = 128.
template <int P, int N>
struct RowsWg {
  using NT = SwTile<TILE, N>;     // C or B rows: K-major and N-major operand
  using PT = SwTile<TILE, P>;     // x or dy rows: K-major and N-major
  using ST = SwTile<P, N>;        // S_{c-1} or G_c, hi or lo
  static constexpr int N_BYTES = round_up(NT::BYTES, 1024);
  static constexpr int P_BYTES = round_up(PT::BYTES, 1024);
  static constexpr int S_BYTES = round_up(ST::BYTES, 1024);
  static constexpr int STAGE = N_BYTES + P_BYTES;
  static constexpr int OWN_P = N_BYTES;
  static constexpr int STATE = STAGE;
  static constexpr int RING = STATE + 2 * S_BYTES;
  static constexpr int CUM = RING + 2 * STAGE;
  static constexpr int BYTES = CUM + 2 * MAX_Q * 4;
};

// e^x on the special-function unit.  x is a difference of two cums (or
// one cum), taken in natural units before the scale: scaling each cum to
// log2 units first would round each by up to |cum| 2^-24, an error that
// the difference keeps and the exp turns into a relative one.
__device__ __forceinline__ float exp_sfu(float x) { return ex2(x * LOG2E); }

// Two bf16 values of a swizzled tile (row r, columns col and col + 1, col
// even), as floats.
template <typename Tile>
__device__ __forceinline__ float2 tile_pair(const unsigned char* tile, int r,
                                            int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + Tile::offset(r, col / 8) + (col % 8) * 2));
}

// The A fragments of columns kk*16 + [0, 16) of a 64 x 64 fp32 accumulator
// tile, split into bf16 high and low parts (flash packs P so).
__device__ __forceinline__ void split_fragments(const float (&s)[8][4],
                                                uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_bf16(s[2 * kk][0], s[2 * kk][1], hi[kk][0], lo[kk][0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], hi[kk][1], lo[kk][1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// Copy a slot's high and low state tiles (as the state pass laid them out)
// into shared memory with cp.async.
template <int P, int N>
__device__ __forceinline__ void load_state_tiles(unsigned char* hi,
                                                 unsigned char* lo,
                                                 const unsigned char* src,
                                                 int tid) {
  constexpr int BYTES = SwTile<P, N>::BYTES;
  for (int e = tid; e < BYTES / 16; e += WG) {
    cp_async16(smem_addr(hi + 16 * e), src + 16 * e, true);
    cp_async16(smem_addr(lo + 16 * e), src + BYTES + 16 * e, true);
  }
}

// The quad's four column slices of a row's dot product, summed.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 3a. The rows pass, rows i (bf16): one warpgroup per (chunk; hb heads of
// one group; 64-row tile i, batch), the tiles with the most pairs first.
// For each head: dC_i += exp(cum_i) dy_i S_{c-1}, then for every tile
// j <= i the scores C_i B_j^T and dy_i x_j^T, W = L o dt_j o (dy_i x_j^T)
// masked to j <= i before the exp, dy_i . y_i += rowsum(C_i B_j^T o W) and
// dC_i += W B_j.  dC_i sums over the block's heads in registers and goes
// out once, a partial of the group's sum; dy_i . y_i goes out by head.
template <int P, int N>
__global__ void __launch_bounds__(WG)
ssd_bwd_rows_i(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
               const bf16* __restrict__ dy,
               const unsigned char* __restrict__ s_tiles,
               const float* __restrict__ cum_ws, float* __restrict__ rowd_ws,
               float* __restrict__ dCp, int S, int H, int G, int Q, int hb) {
  using L = RowsWg<P, N>;
  using NT = typename L::NT;
  using PT = typename L::PT;
  using ST = typename L::ST;
  constexpr int NN = N / 8, KN = N / 16, KP = P / 16;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Cs = smem;                    // C_i
  unsigned char* DYs = smem + L::OWN_P;        // dy_i, by head
  unsigned char* Sh = smem + L::STATE;         // S_{c-1}, by head
  unsigned char* Sl = Sh + L::S_BYTES;
  unsigned char* ring = smem + L::RING;        // a stage: B_j, then x_j
  float* cum = reinterpret_cast<float*>(smem + L::CUM);
  float* dts = cum + MAX_Q;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int nc = gridDim.x, c = blockIdx.x;
  const int nt = (Q + TILE - 1) / TILE, batch = gridDim.z / nt;
  const int ti = nt - 1 - blockIdx.z / batch, b = blockIdx.z % batch;
  const int t0 = c * Q, rows = min(Q, S - t0), i0 = ti * TILE;
  if (i0 >= rows) return;                 // past the last chunk's rows
  const int h0 = blockIdx.y * hb;
  const long x_row = long(H) * P, bc_row = long(G) * N;
  const long bc_off = ((long(b) * S + t0) * G + h0 / (H / G)) * N;
  const bf16* Bb = Bm + bc_off;
  const uint32_t Ca = smem_addr(Cs), DYa = smem_addr(DYs);
  const uint32_t Sha = smem_addr(Sh), Sla = smem_addr(Sl);
  const int ra = i0 + warp * 16 + g, rb = ra + 8;   // this thread's rows i
  load_sw_tile<TILE, N, WG>(Cs, Cm + bc_off + i0 * bc_row, bc_row, rows - i0,
                            tid);                   // with head 0's group

  float accC[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accC[n][e] = 0.f;

  for (int hh = 0; hh < hb; ++hh) {
    const int h = h0 + hh;
    const long slot = (long(b) * H + h) * nc + c;
    const bf16* xh = x + ((long(b) * S + t0) * H + h) * P;
    auto issue = [&](int tj) {
      if (tj <= ti) {
        unsigned char* st = ring + (tj % 2) * L::STAGE;
        const int j0 = tj * TILE;
        load_sw_tile<TILE, N, WG>(st, Bb + j0 * bc_row, bc_row, rows - j0,
                                  tid);
        load_sw_tile<TILE, P, WG>(st + L::N_BYTES, xh + j0 * x_row, x_row,
                                  rows - j0, tid);
      }
      cp_async_commit();
    };
    __syncthreads();              // the last head's tiles and cum are read
    load_sw_tile<TILE, P, WG>(DYs, dy + ((long(b) * S + t0) * H + h) * P +
                                       i0 * x_row,
                              x_row, rows - i0, tid);
    load_state_tiles<P, N>(Sh, Sl, s_tiles + slot * 2 * ST::BYTES, tid);
    issue(0);                     // one group: dy_i, S_{c-1}'s tiles, tile 0
    for (int r = tid; r < i0 + TILE; r += WG) {
      cum[r] = cum_ws[slot * Q + min(r, Q - 1)];
      dts[r] = r < rows ? dt[(long(b) * S + t0 + r) * H + h] : 0.f;
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    // dy_i S_{c-1} (its high, then its low part), rows times exp(cum_i):
    // into dC_i, and dotted with C_i into dy_i . y_i
    const float cum_a = cum[ra], cum_b = cum[rb];
    float rda = 0.f, rdb = 0.f;
    {
      float t[NN][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_ss<1>(t, PT::k_major(DYa, kk), ST::n_major(Sha, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_ss<1>(t, PT::k_major(DYa, kk), ST::n_major(Sla, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(t);
      const float ea = exp_sfu(cum_a), eb = exp_sfu(cum_b);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int col = 8 * n + 2 * q;
        const float2 ca = tile_pair<NT>(Cs, ra - i0, col);
        const float2 cb = tile_pair<NT>(Cs, rb - i0, col);
        t[n][0] *= ea;
        t[n][1] *= ea;
        t[n][2] *= eb;
        t[n][3] *= eb;
        rda += t[n][0] * ca.x + t[n][1] * ca.y;
        rdb += t[n][2] * cb.x + t[n][3] * cb.y;
#pragma unroll
        for (int e = 0; e < 4; ++e) accC[n][e] += t[n][e];
      }
    }

    for (int tj = 0; tj <= ti; ++tj) {
      // tile tj has landed; after the barrier tile tj-1's stage is free
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      issue(tj + 1);
      const uint32_t Ba = smem_addr(ring + (tj % 2) * L::STAGE);
      const uint32_t Xa = Ba + L::N_BYTES;

      // C_i B_j^T and dy_i x_j^T: 64 rows i x 64 rows j
      float s[8][4], d[8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        wgmma_ss(s, NT::k_major(Ca, kk), NT::k_major(Ba, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_ss(d, PT::k_major(DYa, kk), PT::k_major(Xa, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(d);

      // W in d's registers; on the diagonal tile the mask selects j <= i
      // before the exp (above it the exponent is positive)
      const int j0 = tj * TILE;
      const bool diag = tj == ti;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 8 * n + 2 * q + (e & 1);
          const bool lower = e < 2;
          const bool ok = !diag || j <= (lower ? ra : rb);
          const float w =
              ok ? exp_sfu((lower ? cum_a : cum_b) - cum[j]) * dts[j] *
                       d[n][e]
                 : 0.f;
          if (lower)
            rda += s[n][e] * w;
          else
            rdb += s[n][e] * w;
          d[n][e] = w;
        }
      // dC_i += W B_j: W's fragments, high and low, and B_j N-major
      uint32_t wh[4][4], wl[4][4];
      split_fragments(d, wh, wl);
      fence_regs(accC);
      fence_regs(wh);
      fence_regs(wl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = NT::n_major(Ba, kk);
        wgmma_rs<1>(accC, wh[kk], desc, 1);
        wgmma_rs<1>(accC, wl[kk], desc, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(accC);
      fence_regs(wh);
      fence_regs(wl);
    }
    cp_async_wait<0>();                   // the last, empty group

    rda = quad_sum(rda);
    rdb = quad_sum(rdb);
    if (q == 0) {
      if (ra < rows) rowd_ws[slot * Q + ra] = rda;
      if (rb < rows) rowd_ws[slot * Q + rb] = rdb;
    }
  }

  // the block's heads' sum of dC_i: partial blockIdx.y of gridDim.y
  const long HP = gridDim.y;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = 8 * n + 2 * q;
    if (ra < rows)
      *reinterpret_cast<float2*>(
          dCp + ((long(b) * S + t0 + ra) * HP + blockIdx.y) * N + col) =
          make_float2(accC[n][0], accC[n][1]);
    if (rb < rows)
      *reinterpret_cast<float2*>(
          dCp + ((long(b) * S + t0 + rb) * HP + blockIdx.y) * N + col) =
          make_float2(accC[n][2], accC[n][3]);
  }
}

// 3b. The rows pass, rows j (bf16): one warpgroup per (chunk; hb heads of
// one group; 64-row tile j, batch), the tiles with the most pairs first.
// For each head: br_j = exp(cum_last - cum_j) B_j G_c^T and
// dB_j += exp(cum_last - cum_j) dt_j x_j G_c, then for every tile i >= j
// the transposed scores B_j C_i^T and x_j dy_i^T (rows j, columns i), so
// that the weights feed the next products from registers as they are:
// br_j += (C_i B_j^T o L)^T dy_i, dB_j += (L o dt_j o dy_i x_j^T)^T C_i,
// masked to i >= j before the exp.  Then dx_j = dt_j br_j and ddt's direct
// part x_j . br_j go out by head; dB_j sums over the block's heads in
// registers and goes out once, a partial of the group's sum.
template <int P, int N>
__global__ void __launch_bounds__(WG)
ssd_bwd_rows_j(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
               const bf16* __restrict__ dy,
               const unsigned char* __restrict__ g_tiles,
               const float* __restrict__ cum_ws, bf16* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dBp, int S, int H,
               int G, int Q, int hb) {
  using L = RowsWg<P, N>;
  using NT = typename L::NT;
  using PT = typename L::PT;
  using ST = typename L::ST;
  constexpr int NN = N / 8, NP = P / 8, KN = N / 16, KP = P / 16;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Bs = smem;                    // B_j
  unsigned char* Xs = smem + L::OWN_P;         // x_j, by head
  unsigned char* Gh = smem + L::STATE;         // G_c, by head
  unsigned char* Gl = Gh + L::S_BYTES;
  unsigned char* ring = smem + L::RING;        // a stage: C_i, then dy_i
  float* cum = reinterpret_cast<float*>(smem + L::CUM);
  float* dts = cum + MAX_Q;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int nc = gridDim.x, c = blockIdx.x;
  const int nt = (Q + TILE - 1) / TILE, batch = gridDim.z / nt;
  const int tj = blockIdx.z / batch, b = blockIdx.z % batch;
  const int t0 = c * Q, rows = min(Q, S - t0), j0 = tj * TILE;
  if (j0 >= rows) return;                 // past the last chunk's rows
  const int h0 = blockIdx.y * hb;
  const long x_row = long(H) * P, bc_row = long(G) * N;
  const long bc_off = ((long(b) * S + t0) * G + h0 / (H / G)) * N;
  const bf16* Cb = Cm + bc_off;
  const uint32_t Ba = smem_addr(Bs), Xa = smem_addr(Xs);
  const uint32_t Gha = smem_addr(Gh), Gla = smem_addr(Gl);
  const int ra = j0 + warp * 16 + g, rb = ra + 8;   // this thread's rows j
  const int n_it = nt - tj;               // the tiles i >= j
  load_sw_tile<TILE, N, WG>(Bs, Bm + bc_off + j0 * bc_row, bc_row, rows - j0,
                            tid);                   // with head 0's group

  float accB[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accB[n][e] = 0.f;

  for (int hh = 0; hh < hb; ++hh) {
    const int h = h0 + hh;
    const long slot = (long(b) * H + h) * nc + c;
    const bf16* xh = x + ((long(b) * S + t0) * H + h) * P;
    const bf16* dyh = dy + ((long(b) * S + t0) * H + h) * P;
    auto issue = [&](int it) {
      if (it < n_it) {
        unsigned char* st = ring + (it % 2) * L::STAGE;
        const int i0 = (tj + it) * TILE;
        load_sw_tile<TILE, N, WG>(st, Cb + i0 * bc_row, bc_row, rows - i0,
                                  tid);
        load_sw_tile<TILE, P, WG>(st + L::N_BYTES, dyh + i0 * x_row, x_row,
                                  rows - i0, tid);
      }
      cp_async_commit();
    };
    __syncthreads();              // the last head's tiles and cum are read
    load_sw_tile<TILE, P, WG>(Xs, xh + j0 * x_row, x_row, rows - j0, tid);
    load_state_tiles<P, N>(Gh, Gl, g_tiles + slot * 2 * ST::BYTES, tid);
    issue(0);                     // one group: x_j, G_c's tiles, tile j
    for (int r = tid; r < nt * TILE; r += WG) {
      cum[r] = cum_ws[slot * Q + min(r, Q - 1)];
      dts[r] = r < rows ? dt[(long(b) * S + t0 + r) * H + h] : 0.f;
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    // br_j = B_j G_c^T (G_c K-major) and x_j G_c (G_c N-major), each from
    // G_c's high, then its low part; rows times exp(cum_last - cum_j)
    const float cum_a = cum[ra], cum_b = cum[rb], last = cum[Q - 1];
    const float dta = dts[ra], dtb = dts[rb];
    float accR[NP][4];
    {
      float t[NN][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        wgmma_ss<0>(accR, NT::k_major(Ba, kk), ST::k_major(Gha, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        wgmma_ss<0>(accR, NT::k_major(Ba, kk), ST::k_major(Gla, kk), 1);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_ss<1>(t, PT::k_major(Xa, kk), ST::n_major(Gha, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_ss<1>(t, PT::k_major(Xa, kk), ST::n_major(Gla, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(accR);
      fence_regs(t);
      const float wa = exp_sfu(last - cum_a), wb = exp_sfu(last - cum_b);
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        accR[n][0] *= wa;
        accR[n][1] *= wa;
        accR[n][2] *= wb;
        accR[n][3] *= wb;
      }
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        accB[n][0] += t[n][0] * (wa * dta);
        accB[n][1] += t[n][1] * (wa * dta);
        accB[n][2] += t[n][2] * (wb * dtb);
        accB[n][3] += t[n][3] * (wb * dtb);
      }
    }

    for (int it = 0; it < n_it; ++it) {
      // tile tj + it has landed; after the barrier the last stage is free
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      issue(it + 1);
      const uint32_t Ca = smem_addr(ring + (it % 2) * L::STAGE);
      const uint32_t Da = Ca + L::N_BYTES;

      // B_j C_i^T and x_j dy_i^T: 64 rows j x 64 rows i
      float s[8][4], d[8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        wgmma_ss(s, NT::k_major(Ba, kk), NT::k_major(Ca, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_ss(d, PT::k_major(Xa, kk), PT::k_major(Da, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(d);

      // (S o L)^T in s, W^T in d; on the diagonal tile the mask selects
      // i >= j before the exp
      const int i0 = (tj + it) * TILE;
      const bool diag = it == 0;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * n + 2 * q + (e & 1);
          const bool lower = e < 2;
          const bool ok = !diag || i >= (lower ? ra : rb);
          const float l =
              ok ? exp_sfu(cum[i] - (lower ? cum_a : cum_b)) : 0.f;
          s[n][e] *= l;
          d[n][e] *= l * (lower ? dta : dtb);
        }
      // br_j += (S o L)^T dy_i, issued while W^T is packed, then
      // dB_j += W^T C_i: dy_i and C_i N-major
      uint32_t sh[4][4], sl[4][4], dh[4][4], dl[4][4];
      split_fragments(s, sh, sl);
      fence_regs(accR);
      fence_regs(sh);
      fence_regs(sl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = PT::n_major(Da, kk);
        wgmma_rs<1>(accR, sh[kk], desc, 1);
        wgmma_rs<1>(accR, sl[kk], desc, 1);
      }
      wgmma_commit();
      split_fragments(d, dh, dl);
      fence_regs(accB);
      fence_regs(dh);
      fence_regs(dl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = NT::n_major(Ca, kk);
        wgmma_rs<1>(accB, dh[kk], desc, 1);
        wgmma_rs<1>(accB, dl[kk], desc, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(accR);
      fence_regs(accB);
      fence_regs(sh);
      fence_regs(sl);
      fence_regs(dh);
      fence_regs(dl);
    }
    cp_async_wait<0>();                   // the last, empty group

    // dx_j = dt_j br_j; ddt's direct part x_j . br_j
    float xba = 0.f, xbb = 0.f;
    bf16* dxa = dx + ((long(b) * S + t0 + ra) * H + h) * P;
    bf16* dxb = dx + ((long(b) * S + t0 + rb) * H + h) * P;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const int col = 8 * n + 2 * q;
      const float2 xa = tile_pair<PT>(Xs, ra - j0, col);
      const float2 xb = tile_pair<PT>(Xs, rb - j0, col);
      xba += accR[n][0] * xa.x + accR[n][1] * xa.y;
      xbb += accR[n][2] * xb.x + accR[n][3] * xb.y;
      if (ra < rows)
        *reinterpret_cast<uint32_t*>(dxa + col) =
            pack_bf16(dta * accR[n][0], dta * accR[n][1]);
      if (rb < rows)
        *reinterpret_cast<uint32_t*>(dxb + col) =
            pack_bf16(dtb * accR[n][2], dtb * accR[n][3]);
    }
    xba = quad_sum(xba);
    xbb = quad_sum(xbb);
    if (q == 0) {
      if (ra < rows) ddt[(long(b) * S + t0 + ra) * H + h] = xba;
      if (rb < rows) ddt[(long(b) * S + t0 + rb) * H + h] = xbb;
    }
  }

  // the block's heads' sum of dB_j: partial blockIdx.y of gridDim.y
  const long HP = gridDim.y;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = 8 * n + 2 * q;
    if (ra < rows)
      *reinterpret_cast<float2*>(
          dBp + ((long(b) * S + t0 + ra) * HP + blockIdx.y) * N + col) =
          make_float2(accB[n][0], accB[n][1]);
    if (rb < rows)
      *reinterpret_cast<float2*>(
          dBp + ((long(b) * S + t0 + rb) * HP + blockIdx.y) * N + col) =
          make_float2(accB[n][2], accB[n][3]);
  }
}

// ---------------------------------------------------------- 4. reduce

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
ssd_bwd_reduce(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ rowd_ws, const float* __restrict__ extra,
           float* __restrict__ ddt, float* __restrict__ dA,
           const float* __restrict__ dBp, const float* __restrict__ dCp,
           T* __restrict__ dB, T* __restrict__ dC, int B, int S, int H,
           int G, int N, int Q, int nc, int HP, int split) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (blockIdx.x < H) {
    // one head: every warp takes whole chunks, (b, c) = warp, warp + 32,
    // ...
    __shared__ float red[RED_THREADS / 32];
    const int h = blockIdx.x, per = ceil_div(Q, 32);
    const float a_h = A[h];
    float dA_w = 0.f;
    for (int bc = warp; bc < B * nc; bc += RED_THREADS / 32) {
      const int b = bc / nc, c = bc % nc;
      const long slot = (long(b) * H + h) * nc + c;
      const int t0 = c * Q, rows = min(Q, S - t0);
      float v[MAX_Q / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_Q / 32; ++k) {
        const int r = lane * per + k;
        v[k] = 0.f;
        if (k < per && r < rows) {           // dcum = dy . y - dt x . br
          const long i = (long(b) * S + t0 + r) * H + h;
          v[k] = rowd_ws[slot * Q + r] - dt[i] * ddt[i];
        }
        if (k < per && r == Q - 1)           // <G_c, S_c>, its partials
          for (int e = 0; e < split; ++e) v[k] += extra[slot * split + e];
        run += v[k];
      }
      // the lanes above this one, summed: a reverse scan of the lanes
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float s = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += s;
      }
      float acc = incl - run;
#pragma unroll
      for (int k = MAX_Q / 32 - 1; k >= 0; --k) {
        const int r = lane * per + k;
        if (k >= per) continue;
        acc += v[k];                        // ddA_r = sum_{i >= r} dcum_i
        if (r < rows) {
          const long i = (long(b) * S + t0 + r) * H + h;
          ddt[i] += a_h * acc;
          dA_w += dt[i] * acc;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dA_w += __shfl_xor_sync(0xffffffffu, dA_w, o);
    if (lane == 0) red[warp] = dA_w;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < RED_THREADS / 32; ++w) sum += red[w];
      dA[h] = sum;
    }
    return;
  }
  // the group sums of the partials of dB and dC (HP a row, HP / G a group)
  const int R = HP / G;
  const long total = long(B) * S * G * N;
  const long stride = long(gridDim.x - H) * RED_THREADS;
  for (long e = long(blockIdx.x - H) * RED_THREADS + tid; e < total;
       e += stride) {
    const int n = int(e % N);
    const long bsg = e / N, g = bsg % G, bs = bsg / G;
    const long src = (bs * HP + g * R) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < R; ++r) {
      sb += dBp[src + long(r) * N];
      sc += dCp[src + long(r) * N];
    }
    dB[e] = from_f<T>(sb);
    dC[e] = from_f<T>(sc);
  }
}

// ------------------------------------------------------------ dispatching

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Heads of a group a bf16 rows block takes (hb): their dB and dC sum in
// its registers, so the partials are H / hb a row.  The wrapper
// (kernels/ssd_scan.py:bwd_heads_per_block) sizes the workspace by it.
int heads_per_block(int H, int G) {
  const int R = H / G;
  return R % 8 == 0 ? 8 : R % 4 == 0 ? 4 : R % 2 == 0 ? 2 : 1;
}

// 4. the reduce pass, both paths: H blocks for dcum's cumsum, ddt and dA,
// then the group sums in a grid-stride loop, about four elements a thread
template <typename T>
cudaError_t launch_reduce(const float* dt, const float* A, const float* rowd,
                          const float* extra, void* ddt, void* dA,
                          const float* dBp, const float* dCp, void* dB,
                          void* dC, int B, int S, int H, int G, int N, int Q,
                          int nc, int HP, int split, cudaStream_t stream) {
  long sum_blocks =
      (long(B) * S * G * N + 4 * RED_THREADS - 1) / (4 * RED_THREADS);
  sum_blocks = sum_blocks > 1024 ? 1024 : sum_blocks;
  ssd_bwd_reduce<T><<<unsigned(H + sum_blocks), RED_THREADS, 0, stream>>>(
      dt, A, rowd, extra, static_cast<float*>(ddt), static_cast<float*>(dA),
      dBp, dCp, static_cast<T*>(dB), static_cast<T*>(dC), B, S, H, G, N, Q,
      nc, HP, split);
  return cudaGetLastError();
}

// The workspace (fp32 elements, kernels/ssd_scan.py:bwd_workspace_floats):
// bf16 only, the high and low tiles of S_{c-1} and of G_c, P N floats' bytes
// a (batch, head, chunk) slot each; then dS_c / S_{c-1} and E_c / G_c
// [B, H, nc, P, N] fp32 each, the partials of dB and dC [B, S, HP, N] each,
// cum and dy . y [B, H, nc, Q] each, the partials of <G_c, S_c>
// [B, H, nc, state_split].
struct Workspace {
  unsigned char *s_tiles, *g_tiles;
  float *states, *grads, *dBp, *dCp, *cum, *rowd, *extra;
  Workspace(void* ws, bool tiles, int B, int S, int H, int HP, int P, int N,
            int Q, int nc) {
    const long slots = long(B) * H * nc, PN = long(P) * N;
    float* w = static_cast<float*>(ws);
    s_tiles = tiles ? reinterpret_cast<unsigned char*>(w) : nullptr;
    g_tiles = tiles ? reinterpret_cast<unsigned char*>(w + slots * PN)
                    : nullptr;
    states = w + (tiles ? 2 * slots * PN : 0);
    grads = states + slots * PN;
    dBp = grads + slots * PN;
    dCp = dBp + long(B) * S * HP * N;
    cum = dCp + long(B) * S * HP * N;
    rowd = cum + slots * Q;
    extra = rowd + slots * Q;
  }
};

// bf16: the chunk pass and both rows passes on wgmma.
template <int P, int N>
cudaError_t launch_wgmma(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, const void* init,
                         const void* dy, const void* dfinal, void* dx,
                         void* ddt, void* dA, void* dB, void* dC,
                         void* dinit, void* ws, int B, int S, int H, int G,
                         int Q, cudaStream_t stream) {
  const int nc = ceil_div(S, Q), nt = ceil_div(Q, TILE);
  const int hb = heads_per_block(H, G), HP = H / hb;
  const Workspace w(ws, true, B, S, H, HP, P, N, Q, nc);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* Bt = static_cast<const bf16*>(Bm);
  const bf16* Ct = static_cast<const bf16*>(Cm);
  const bf16* dyt = static_cast<const bf16*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);

  constexpr int chunk_smem = ChunkWgSmem<P, N>::BYTES;
  auto k1 = ssd_bwd_chunk_wgmma<P, N>;
  cudaError_t err = allow_smem(k1, chunk_smem);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc * 2, H, B), WG, chunk_smem, stream>>>(
      xt, dtf, Af, Bt, Ct, dyt, w.states, w.grads, w.cum, S, H, G, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_state<P, N><<<dim3(B * H, state_split<P, N>()), THREADS, 0,
                        stream>>>(
      w.states, w.grads, w.cum, static_cast<const float*>(init),
      static_cast<const float*>(dfinal), static_cast<float*>(dinit), w.extra,
      w.s_tiles, w.g_tiles, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr int rows_smem = RowsWg<P, N>::BYTES;
  const dim3 rows_grid(nc, HP, nt * B);
  auto ki = ssd_bwd_rows_i<P, N>;
  if ((err = allow_smem(ki, rows_smem)) != cudaSuccess) return err;
  ki<<<rows_grid, WG, rows_smem, stream>>>(xt, dtf, Bt, Ct, dyt, w.s_tiles,
                                           w.cum, w.rowd, w.dCp, S, H, G, Q,
                                           hb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto kj = ssd_bwd_rows_j<P, N>;
  if ((err = allow_smem(kj, rows_smem)) != cudaSuccess) return err;
  kj<<<rows_grid, WG, rows_smem, stream>>>(
      xt, dtf, Bt, Ct, dyt, w.g_tiles, w.cum, static_cast<bf16*>(dx),
      static_cast<float*>(ddt), w.dBp, S, H, G, Q, hb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return launch_reduce<bf16>(dtf, Af, w.rowd, w.extra, ddt, dA, w.dBp, w.dCp,
                             dB, dC, B, S, H, G, N, Q, nc, HP,
                             state_split<P, N>(), stream);
}

// fp32: the CUDA-core kernels, one head a rows block.
template <int P, int N>
cudaError_t launch_simt(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* init,
                        const void* dy, const void* dfinal, void* dx,
                        void* ddt, void* dA, void* dB, void* dC, void* dinit,
                        void* ws, int B, int S, int H, int G, int Q,
                        cudaStream_t stream) {
  const int nc = ceil_div(S, Q);
  const Workspace w(ws, false, B, S, H, H, P, N, Q, nc);
  const float* xt = static_cast<const float*>(x);
  const float* Bt = static_cast<const float*>(Bm);
  const float* Ct = static_cast<const float*>(Cm);
  const float* dyt = static_cast<const float*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);

  using CL = ChunkSmem<float, P, N>;
  auto k1 = ssd_bwd_chunk_simt<float, P, N>;
  cudaError_t err = allow_smem(k1, CL::BYTES);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc, H, B), THREADS, CL::BYTES, stream>>>(
      xt, dtf, Af, Bt, Ct, dyt, w.states, w.grads, w.cum, S, H, G, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_state<P, N><<<dim3(B * H, state_split<P, N>()), THREADS, 0,
                        stream>>>(
      w.states, w.grads, w.cum, static_cast<const float*>(init),
      static_cast<const float*>(dfinal), static_cast<float*>(dinit), w.extra,
      nullptr, nullptr, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  using RL = RowsSmem<float, P, N>;
  constexpr int TR = rows_tile<float, P, N>();
  auto k3 = ssd_bwd_rows_simt<float, P, N>;
  if ((err = allow_smem(k3, RL::BYTES)) != cudaSuccess) return err;
  k3<<<dim3(ceil_div(Q, TR) * nc, H, B), THREADS, RL::BYTES, stream>>>(
      xt, dtf, Bt, Ct, dyt, w.states, w.grads, w.cum, static_cast<float*>(dx),
      static_cast<float*>(ddt), w.rowd, w.dBp, w.dCp, S, H, G, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return launch_reduce<float>(dtf, Af, w.rowd, w.extra, ddt, dA, w.dBp,
                              w.dCp, dB, dC, B, S, H, G, N, Q, nc, H,
                              state_split<P, N>(), stream);
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* init, const void* dy,
             const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
             void* dC, void* dinit, void* ws, int B, int S, int H, int G,
             int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || Q < 1 || Q > MAX_Q ||
      ws == nullptr || (dinit != nullptr && init == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(by_width(P, [&](auto p) {
    return by_width(N, [&](auto n) {
      constexpr int PP = decltype(p)::value, NN = decltype(n)::value;
      if constexpr (sizeof(T) == 2)
        return launch_wgmma<PP, NN>(x, dt, A, Bm, Cm, init, dy, dfinal, dx,
                                    ddt, dA, dB, dC, dinit, ws, B, S, H, G,
                                    Q, st);
      else
        return launch_simt<PP, NN>(x, dt, A, Bm, Cm, init, dy, dfinal, dx,
                                   ddt, dA, dB, dC, dinit, ws, B, S, H, G, Q,
                                   st);
    });
  }));
}

}  // namespace

// bf16 x/B/C/dy and dx/dB/dC (the wgmma kernels); init, dfinal and dinit
// may be NULL (dinit only with init).
extern "C" int ssd_scan_bwd_bf16(const void* x, const void* dt,
                                 const void* A, const void* Bm,
                                 const void* Cm, const void* init,
                                 const void* dy, const void* dfinal,
                                 void* dx, void* ddt, void* dA, void* dB,
                                 void* dC, void* dinit, void* ws, int B,
                                 int S, int H, int G, int P, int N, int Q,
                                 void* stream) {
  return dispatch<bf16>(x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dB,
                        dC, dinit, ws, B, S, H, G, P, N, Q, stream);
}

// fp32: the CUDA-core kernels.
extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm,
                                const void* init, const void* dy,
                                const void* dfinal, void* dx, void* ddt,
                                void* dA, void* dB, void* dC, void* dinit,
                                void* ws, int B, int S, int H, int G, int P,
                                int N, int Q, void* stream) {
  return dispatch<float>(x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dB,
                         dC, dinit, ws, B, S, H, G, P, N, Q, stream);
}

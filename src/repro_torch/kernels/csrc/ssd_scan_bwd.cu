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
// the k_i of the state, and <G_c, S_c> the last row's extra terms.
//
// Layouts as the forward's (ssd_scan.cu): x/dy/dx [B, S, H, P] and
// Bm/Cm/dB/dC [B, S, G, N] in bf16 or fp32 (all the same type), dt/ddt
// [B, S, H] fp32, A/dA [H] fp32, initial state/final state's gradient/dinit
// [B, H, P, N] fp32; all contiguous.  The workspace (fp32, from the caller,
// one per call; kernels/ssd_scan.py:bwd_workspace_floats sizes it):
// S_{c-1} and G_c [B, H, nc, P, N] each, the per-head partials of dB and dC
// [B, S, H, N] each, cum and dcum [B, H, nc, Q] each, <G_c, S_c> [B, H, nc].
//
// Four launches on the current stream, one writer for every element and no
// atomics, so the result does not change from run to run:
//   1. ssd_bwd_chunk, one block per (chunk, head, batch): cum (one warp's scan
//      of dt * A), the chunk's own state dS_c = sum_j exp(cum_last - cum_j)
//      dt_j x_j B_j^T and its dy term E_c = sum_i exp(cum_i) dy_i C_i^T,
//      [P x Q] by [Q x N] products over 64-row slices in shared memory;
//   2. ssd_bwd_state, one block per (batch, head), elementwise over [P, N] and
//      sequential over the chunks: forward from the initial state,
//      S_c = exp(cum_last) S_{c-1} + dS_c, each dS_c's slot overwritten by
//      S_{c-1}; back from the final state's gradient,
//      G_{c-1} = exp(cum_last) G_c + E_c, each E_c's slot overwritten by G_c,
//      and <G_c, S_c> summed over the block in a fixed order;
//   3. ssd_bwd_rows, one block per (row tile of TR rows of a chunk, head,
//      batch).  Its rows as i: dC_i (S_{c-1} staged in shared memory, then
//      the tiles j <= i of the chunk) and dy_i . y_i; its rows as j: br_j
//      and dB_j (G_c staged, then the tiles i >= j).  A tile pair's
//      C_i . B_j and dy_i . x_j are [TR x TR] products; the decay-masked
//      weights go through shared memory into the next products.  Every
//      block walks nt + 1 tile pairs (nt tiles a chunk), so the blocks are
//      even.  It writes dx, ddt's direct part x_j . br_j, dcum, and the
//      per-head partials of dB and dC;
//   4. ssd_bwd_reduce: H blocks, one per head, each warp taking whole chunks:
//      dcum's reverse cumsum (the last row plus <G_c, S_c>), ddt += A ddA,
//      and dA summed per warp, then over the warps in order; the other
//      blocks sum dB's and dC's partials over each group's heads and cast
//      them to the inputs' type.
//
// What bounds it: operations.  A chunk and head take about
// Q (Q + 1)(3 N + 2 P) + 10 Q N P operations (here somewhat more: the
// [TR x TR] products of a tile pair are made once by each of its two
// blocks), far above the card's ridge.  This first version runs them all in
// fp32 on CUDA cores (67 TFLOP/s at most): every product is a register tile
// (each thread 16 rows apart, TR / 16 by the output's width / 16) over
// operands in shared memory, rows padded by one 32-bit word so that the
// transposed reads of another tile's rows fall on distinct banks.  Tiles
// are stored in the inputs' type (bf16 halves them), all sums are fp32,
// and the cancelling dcum and its cumsum stay fp32.  Putting the [TR x TR]
// products on wgmma is work for a later version.
//
// Above the diagonal cum_i - cum_j > 0 (A < 0, dt >= 0), so the mask is
// applied before the exp, as in the forward; the ragged tail and rows past
// the chunk are zero with dt = 0, so they add nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;      // a 16 x 16 grid of threads
constexpr int SLICE = 64;         // rows of a slice in ssd_bwd_chunk

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

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

// ---------------------------------------------------------- 1. chunk

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
ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
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

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state(float* __restrict__ states, float* __restrict__ grads,
          const float* __restrict__ cum_ws, const float* __restrict__ init,
          const float* __restrict__ dfinal, float* __restrict__ dinit,
          float* __restrict__ extra, int Q, int nc) {
  constexpr int PN = P * N, PN4 = PN / 4, PER = ceil_div(PN4, THREADS);
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x;
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
    const int i = tid + k * THREADS;
    s[k] = i < PN4 ? load4(init, i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // forward: each dS_c's slot takes S_{c-1}; s ends as the final state
  for (int c = 0; c < nc; ++c) {
    const float decay = expf(cum_ws[(bh * nc + c) * Q + Q - 1]);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * THREADS;
      if (i >= PN4) continue;
      const float4 d = st[c * PN4 + i];
      st[c * PN4 + i] = s[k];
      s[k] = make_float4(fmaf(decay, s[k].x, d.x), fmaf(decay, s[k].y, d.y),
                         fmaf(decay, s[k].z, d.z), fmaf(decay, s[k].w, d.w));
    }
  }
  // back: each E_c's slot takes G_c; s walks back from S_{nc-1}
  float4 g[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS;
    g[k] = i < PN4 ? load4(dfinal, i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = nc - 1; c >= 0; --c) {
    const float decay = expf(cum_ws[(bh * nc + c) * Q + Q - 1]);
    float part = 0.f;                       // <G_c, S_c>, this thread's
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * THREADS;
      if (i >= PN4) continue;
      part += g[k].x * s[k].x + g[k].y * s[k].y + g[k].z * s[k].z +
              g[k].w * s[k].w;
      const float4 e = gr[c * PN4 + i];
      gr[c * PN4 + i] = g[k];
      s[k] = st[c * PN4 + i];               // S_{c-1}
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
      extra[bh * nc + c] = sum;
    }
    __syncthreads();
  }
  if (dinit != nullptr) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * THREADS;
      if (i >= PN4) continue;
      float* p = dinit + bh * PN + 4 * i;
      p[0] = g[k].x;
      p[1] = g[k].y;
      p[2] = g[k].z;
      p[3] = g[k].w;
    }
  }
}

// ---------------------------------------------------------- 3. rows

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
ssd_bwd_rows(const T* __restrict__ x, const float* __restrict__ dt,
         const T* __restrict__ Bm, const T* __restrict__ Cm,
         const T* __restrict__ dy, const float* __restrict__ states,
         const float* __restrict__ grads, const float* __restrict__ cum_ws,
         T* __restrict__ dx, float* __restrict__ ddt,
         float* __restrict__ dcum_ws, float* __restrict__ dBp,
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
    if (gj < Q && tx == 0) dcum_ws[slot * Q + gj] = rowd[a] - dtv[gj] * xb;
    if (j >= n_valid(t)) continue;
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

// ---------------------------------------------------------- 4. reduce

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ dcum_ws, const float* __restrict__ extra,
           float* __restrict__ ddt, float* __restrict__ dA,
           const float* __restrict__ dBp, const float* __restrict__ dCp,
           T* __restrict__ dB, T* __restrict__ dC, int B, int S, int H,
           int G, int N, int Q, int nc) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (blockIdx.x < H) {
    // one head: every warp takes whole chunks, (b, c) = warp, warp + 8, ...
    __shared__ float red[THREADS / 32];
    const int h = blockIdx.x, per = ceil_div(Q, 32);
    const float a_h = A[h];
    float dA_w = 0.f;
    for (int bc = warp; bc < B * nc; bc += THREADS / 32) {
      const int b = bc / nc, c = bc % nc;
      const long slot = (long(b) * H + h) * nc + c;
      const int t0 = c * Q, rows = min(Q, S - t0);
      float v[MAX_Q / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_Q / 32; ++k) {
        const int r = lane * per + k;
        v[k] = 0.f;
        if (k < per && r < Q) {
          v[k] = dcum_ws[slot * Q + r];
          if (r == Q - 1) v[k] += extra[slot];   // <G_c, S_c>
        }
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
      for (int w = 0; w < THREADS / 32; ++w) sum += red[w];
      dA[h] = sum;
    }
    return;
  }
  // the group sums of the per-head partials of dB and dC
  const int R = H / G;
  const long total = long(B) * S * G * N;
  const long stride = long(gridDim.x - H) * THREADS;
  for (long e = long(blockIdx.x - H) * THREADS + tid; e < total;
       e += stride) {
    const int n = int(e % N);
    const long bsg = e / N, g = bsg % G, bs = bsg / G;
    const long src = (bs * H + g * R) * N + n;
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

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* init,
                   const void* dy, const void* dfinal, void* dx, void* ddt,
                   void* dA, void* dB, void* dC, void* dinit, void* ws,
                   int B, int S, int H, int G, int Q, cudaStream_t stream) {
  const int nc = ceil_div(S, Q);
  const long slots = long(B) * H * nc;
  float* w = static_cast<float*>(ws);
  float* states = w;
  float* grads = states + slots * P * N;
  float* dBp = grads + slots * P * N;
  float* dCp = dBp + long(B) * S * H * N;
  float* cum = dCp + long(B) * S * H * N;
  float* dcum = cum + slots * Q;
  float* extra = dcum + slots * Q;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);

  using CL = ChunkSmem<T, P, N>;
  auto k1 = ssd_bwd_chunk<T, P, N>;
  cudaError_t err = allow_smem(k1, CL::BYTES);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc, H, B), THREADS, CL::BYTES, stream>>>(
      xt, dtf, Af, Bt, Ct, dyt, states, grads, cum, S, H, G, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_state<P, N><<<unsigned(B * H), THREADS, 0, stream>>>(
      states, grads, cum, static_cast<const float*>(init),
      static_cast<const float*>(dfinal), static_cast<float*>(dinit), extra,
      Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  using RL = RowsSmem<T, P, N>;
  constexpr int TR = rows_tile<T, P, N>();
  auto k3 = ssd_bwd_rows<T, P, N>;
  if ((err = allow_smem(k3, RL::BYTES)) != cudaSuccess) return err;
  k3<<<dim3(ceil_div(Q, TR) * nc, H, B), THREADS, RL::BYTES, stream>>>(
      xt, dtf, Bt, Ct, dyt, states, grads, cum, static_cast<T*>(dx),
      static_cast<float*>(ddt), dcum, dBp, dCp, S, H, G, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // the group sums: a grid-stride loop, about four elements a thread
  long sum_blocks = (long(B) * S * G * N + 4 * THREADS - 1) / (4 * THREADS);
  sum_blocks = sum_blocks > 4096 ? 4096 : sum_blocks;
  ssd_bwd_reduce<T><<<unsigned(H + sum_blocks), THREADS, 0, stream>>>(
      dtf, Af, dcum, extra, static_cast<float*>(ddt),
      static_cast<float*>(dA), dBp, dCp, static_cast<T*>(dB),
      static_cast<T*>(dC), B, S, H, G, N, Q, nc);
  return cudaGetLastError();
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
      return launch<T, decltype(p)::value, decltype(n)::value>(
          x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dB, dC, dinit, ws,
          B, S, H, G, Q, st);
    });
  }));
}

}  // namespace

// bf16 x/B/C/dy and dx/dB/dC; init, dfinal and dinit may be NULL (dinit
// only with init).
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

// fp32: the same kernels over fp32 tiles.
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

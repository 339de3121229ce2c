// The backward pass of prefill attention for Hopper (sm_90a), written by
// hand.
//
// No TPU kernel to replace: no Pallas kernel in repro/ has a backward, and
// the JAX model trains through blocked_attention (repro/models/layers.py),
// which XLA differentiates, recomputing the scores block by block under
// jax.checkpoint.  This computes the same gradient of the function that
// flash_attention.cu computes (GQA, causal or not, a sliding window, a tanh
// softcap), from q, k, v, the forward's output o and its row log-sum-exp
// lse, and the output's gradient dO:
//   P   = exp(s - lse), s the scaled (and capped) score, 0 where masked
//   dV  = P^T dO                         dP = dO V^T
//   dS  = P o (dP - Delta) [o (1 - tanh^2(s_raw scale / cap)) under a cap]
//   dQ  = scale dS K                     dK = scale dS^T Q
// with Delta = rowsum(dO o O).  Three launches on the current stream:
//   1. fa_bwd_delta: Delta in fp32, one warp a (batch, position, head) row;
//   2. fa_bwd_dkdv:  one block per (64-key KV tile, KV head, batch).  It
//      walks the G query heads of its group and, for each, the q tiles
//      that see its KV tile (the forward's band skipping,
//      kernels/flash_attention.py:_tile_needed), recomputing P and dS tile
//      by tile and summing dK and dV in registers: no other block writes
//      them, so there are no atomics;
//   3. fa_bwd_dq:    one block per (64-row q tile, head, batch), walking
//      the KV tiles its band holds and summing dQ in registers.
// Every sum is fp32 in a fixed order, so the result does not change from
// run to run.  Delta is the caller's workspace, one per call.
//
// Layouts as the forward's: q/o/dO/dQ [B, S, H, D], k/v/dK/dV
// [B, T, KVH, D], contiguous, all bf16 or all fp32; lse and Delta fp32
// [B, H, S].  Head dims 64 and 128; keys are never cut by a kv_len.
//
// What bounds it: five products of 2 D operations a (q, k) pair (2.5x the
// forward's four D), far above the card's ridge, so the tensor cores
// should set the pace.  This first version is simple and runs on CUDA
// cores in fp32: the tiles are converted to fp32 in shared memory (rows
// padded by one float, so a column read is free of bank conflicts), each
// of 256 threads owns a 4 x 4 block of each score tile and 4 rows of the
// D-wide sums.  The dK/dV and dQ passes each recompute the scores and dP,
// seven products in all.  Putting it on wgmma with TMA loads is later
// work; PERF.md has its time beside its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows a tile
constexpr int BK = 64;            // keys a tile
constexpr int TY = 16;            // thread grid: TY x TX = 256 threads
constexpr int TX = 16;
constexpr int THREADS = TY * TX;
constexpr int RQ = BQ / TY;       // score rows a thread
constexpr int CK = BK / TX;       // score columns a thread
constexpr int PS = BK + 1;        // row stride of the P and dS tiles
constexpr int DELTA_WARPS = 8;    // rows a block of the Delta pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// kernels/flash_attention.py:_tile_needed: does the KV tile at k_start
// touch the visible band of the q tile at q_start?
__device__ __forceinline__ bool tile_needed(int q_start, int k_start,
                                            int kv_len, int causal,
                                            int window) {
  bool needed = k_start < kv_len;
  if (causal) needed = needed && k_start <= q_start + BQ - 1;
  if (window > 0) needed = needed && k_start + BK - 1 > q_start - window;
  return needed;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int kv_len,
                                        int causal, int window) {
  bool ok = kpos < kv_len;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// 64 rows of D values (row r at src + r * stride) into a [64][D + 1] fp32
// tile; rows at or past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long stride, int valid, int tid) {
  for (int e = tid; e < 64 * D; e += THREADS) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < valid ? to_f(src[r * stride + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[row ty*RQ + i][d] * B[row tx + j*TX][d] over two
// [64][D + 1] tiles: a 64 x 64 product of A and B^T.
template <int D>
__device__ __forceinline__ void product_abt(float (&acc)[RQ][CK],
                                            const float* A, const float* B,
                                            int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[RQ], b[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) a[i] = A[(ty * RQ + i) * DP + d];
#pragma unroll
    for (int j = 0; j < CK; ++j) b[j] = B[(tx + j * TX) * DP + d];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// P and dS of one 64 x 64 tile into shared memory, from the score and dP
// products (s, dp), the rows' lse and Delta: masked entries and rows past
// S take 0.  dS leaves out the factor `scale` (applied to dQ and dK once).
template <bool SOFTCAP>
__device__ __forceinline__ void p_and_ds(
    const float (&s)[RQ][CK], const float (&dp)[RQ][CK], float* Ps,
    float* dSs, const float* rowL, const float* rowD, int q_start,
    int k_start, int S, int kv_len, int causal, int window, float softcap,
    float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i, qpos = q_start + r;
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

// ------------------------------------------------------------ 1. Delta

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

// ------------------------------------------------------------ 2. dK, dV

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) *
         (4 * size_t(64) * (D + 1) + 2 * size_t(BQ) * PS + 2 * BQ);
}

template <typename T, int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int T_len, int H,
            int KVH, int causal, int window, float softcap, float scale) {
  constexpr int DP = D + 1;
  constexpr int AD = D / TX;            // D-wide columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;                     // [BK][DP]
  float* Vs = Ks + BK * DP;             // [BK][DP]
  float* Qs = Vs + BK * DP;             // [BQ][DP]
  float* dOs = Qs + BQ * DP;            // [BQ][DP]
  float* Ps = dOs + BQ * DP;            // [BQ][PS]
  float* dSs = Ps + BQ * PS;            // [BQ][PS]
  float* rowL = dSs + BQ * PS;          // [BQ]
  float* rowD = rowL + BQ;              // [BQ]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int k_start = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const long q_stride = long(H) * D, kv_stride = long(KVH) * D;
  const long kv_off = (long(b) * T_len + k_start) * kv_stride + long(kvh) * D;
  load_tile<T, D>(Ks, k + kv_off, kv_stride, T_len - k_start, tid);
  load_tile<T, D>(Vs, v + kv_off, kv_stride, T_len - k_start, tid);

  float dk_acc[RQ][AD], dv_acc[RQ][AD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int a = 0; a < AD; ++a) dk_acc[i][a] = dv_acc[i][a] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long q_head = long(b) * S * H * D + long(h) * D;
    const long row_head = (long(b) * H + h) * S;
    for (int qi = 0; qi < nq; ++qi) {
      const int q_start = qi * BQ;
      if (!tile_needed(q_start, k_start, T_len, causal, window)) continue;
      __syncthreads();                  // the last tile's readers are done
      const long q_off = q_head + long(q_start) * q_stride;
      load_tile<T, D>(Qs, q + q_off, q_stride, S - q_start, tid);
      load_tile<T, D>(dOs, dout + q_off, q_stride, S - q_start, tid);
      for (int r = tid; r < BQ; r += THREADS) {
        const bool in = q_start + r < S;
        rowL[r] = in ? lse[row_head + q_start + r] : 0.f;
        rowD[r] = in ? delta[row_head + q_start + r] : 0.f;
      }
      __syncthreads();

      float s[RQ][CK], dp[RQ][CK];
      product_abt<D>(s, Qs, Ks, ty, tx);     // S = Q K^T
      product_abt<D>(dp, dOs, Vs, ty, tx);   // dP = dO V^T
      p_and_ds<SOFTCAP>(s, dp, Ps, dSs, rowL, rowD, q_start, k_start, S,
                        T_len, causal, window, softcap, scale, ty, tx);
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: this thread's keys ty*RQ + i, columns
      // tx + a*TX
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RQ], dsv[RQ], dov[AD], qv[AD];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          pv[i] = Ps[r * PS + ty * RQ + i];
          dsv[i] = dSs[r * PS + ty * RQ + i];
        }
#pragma unroll
        for (int a = 0; a < AD; ++a) {
          dov[a] = dOs[r * DP + tx + a * TX];
          qv[a] = Qs[r * DP + tx + a * TX];
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int a = 0; a < AD; ++a) {
            dv_acc[i][a] = fmaf(pv[i], dov[a], dv_acc[i][a]);
            dk_acc[i][a] = fmaf(dsv[i], qv[a], dk_acc[i][a]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = k_start + ty * RQ + i;
    if (t >= T_len) continue;
    const long off = (long(b) * T_len + t) * kv_stride + long(kvh) * D;
#pragma unroll
    for (int a = 0; a < AD; ++a) {
      dk[off + tx + a * TX] = from_f<T>(dk_acc[i][a] * scale);
      dv[off + tx + a * TX] = from_f<T>(dv_acc[i][a]);
    }
  }
}

// ------------------------------------------------------------------ 3. dQ

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * size_t(64) * (D + 1) + size_t(BQ) * PS +
                          2 * BQ);
}

template <typename T, int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int T_len, int H, int KVH, int causal,
          int window, float softcap, float scale) {
  constexpr int DP = D + 1;
  constexpr int AD = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][DP]
  float* dOs = Qs + BQ * DP;            // [BQ][DP]
  float* Ks = dOs + BQ * DP;            // [BK][DP]
  float* Vs = Ks + BK * DP;             // [BK][DP]
  float* dSs = Vs + BK * DP;            // [BQ][PS]
  float* rowL = dSs + BQ * PS;          // [BQ]
  float* rowD = rowL + BQ;              // [BQ]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  // the causal q tiles with the most KV tiles start first
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_stride = long(H) * D, kv_stride = long(KVH) * D;
  const long q_off = (long(b) * S + q_start) * q_stride + long(h) * D;
  const long row_head = (long(b) * H + h) * S;
  load_tile<T, D>(Qs, q + q_off, q_stride, S - q_start, tid);
  load_tile<T, D>(dOs, dout + q_off, q_stride, S - q_start, tid);
  for (int r = tid; r < BQ; r += THREADS) {
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
    if (!tile_needed(q_start, k_start, T_len, causal, window)) continue;
    __syncthreads();                    // the last tile's readers are done
    const long kv_off =
        (long(b) * T_len + k_start) * kv_stride + long(kvh) * D;
    load_tile<T, D>(Ks, k + kv_off, kv_stride, T_len - k_start, tid);
    load_tile<T, D>(Vs, v + kv_off, kv_stride, T_len - k_start, tid);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
    product_abt<D>(s, Qs, Ks, ty, tx);
    product_abt<D>(dp, dOs, Vs, ty, tx);
    p_and_ds<SOFTCAP>(s, dp, nullptr, dSs, rowL, rowD, q_start, k_start, S,
                      T_len, causal, window, softcap, scale, ty, tx);
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
      dq[off + tx + a * TX] = from_f<T>(dq_acc[i][a] * scale);
  }
}

// ------------------------------------------------------------ launching

template <typename T, int D, bool SOFTCAP>
cudaError_t launch(const T* q, const T* k, const T* v, const T* o,
                   const float* lse, const T* dout, T* dq, T* dk, T* dv,
                   float* delta, int B, int S, int T_len, int H, int KVH,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const long rows = long(B) * S * H;
  fa_bwd_delta<T, D><<<unsigned((rows + DELTA_WARPS - 1) / DELTA_WARPS),
                       32 * DELTA_WARPS, 0, stream>>>(o, dout, delta, S, H,
                                                      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = fa_bwd_dkdv<T, D, SOFTCAP>;
  err = cudaFuncSetAttribute(dkdv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dkdv_smem_bytes<D>()));
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((T_len + BK - 1) / BK, KVH, B), THREADS, dkdv_smem_bytes<D>(),
         stream>>>(q, k, v, dout, lse, delta, dk, dv, S, T_len, H, KVH,
                   causal, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = fa_bwd_dq<T, D, SOFTCAP>;
  err = cudaFuncSetAttribute(dqk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dq_smem_bytes<D>()));
  if (err != cudaSuccess) return err;
  dqk<<<dim3((S + BQ - 1) / BQ, H, B), THREADS, dq_smem_bytes<D>(),
        stream>>>(q, k, v, dout, lse, delta, dq, S, T_len, H, KVH, causal,
                  window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, void* dq, void* dk,
             void* dv, float* delta, int B, int S, int T_len, int H,
             int KVH, int D, int causal, int window, float softcap,
             float scale, void* stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* do_ = static_cast<const T*>(dout);
  T* dq_ = static_cast<T*>(dq);
  T* dk_ = static_cast<T*>(dk);
  T* dv_ = static_cast<T*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
#define FA_BWD_LAUNCH(DIM)                                                  \
  return cap ? launch<T, DIM, true>(q_, k_, v_, o_, lse, do_, dq_, dk_, dv_, \
                                    delta, B, S, T_len, H, KVH, causal,     \
                                    window, softcap, scale, st)             \
             : launch<T, DIM, false>(q_, k_, v_, o_, lse, do_, dq_, dk_,    \
                                     dv_, delta, B, S, T_len, H, KVH,       \
                                     causal, window, softcap, scale, st)
  switch (D) {
    case 64:
      FA_BWD_LAUNCH(64);
    case 128:
      FA_BWD_LAUNCH(128);
    default:
      return int(cudaErrorInvalidValue);
  }
#undef FA_BWD_LAUNCH
}

}  // namespace

// q, k, v, o, lse, dO -> dQ, dK, dV (bf16); delta: the caller's fp32
// [B, H, S] workspace.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const float* lse, const void* dout,
                                        void* dq, void* dk, void* dv,
                                        float* delta, int B, int S,
                                        int T_len, int H, int KVH, int D,
                                        int causal, int window,
                                        float softcap, float scale,
                                        void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,
                                 S, T_len, H, KVH, D, causal, window,
                                 softcap, scale, stream);
}

// The same in fp32.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const float* lse, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       float* delta, int B, int S, int T_len,
                                       int H, int KVH, int D, int causal,
                                       int window, float softcap,
                                       float scale, void* stream) {
  return dispatch<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S,
                         T_len, H, KVH, D, causal, window, softcap, scale,
                         stream);
}

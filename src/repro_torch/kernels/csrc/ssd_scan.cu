// Mamba-2 SSD chunked scan for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_kernel (body
// _kernel).  Same function: per chunk of Q rows, with cum the running sum of
// dt * A inside the chunk,
//   y[i]   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) C_i . state                       (carried state)
//   state' = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// with grouped B/C (head h reads group h / (H/G)), an optional initial state
// and the final state out.
//
// Layouts: x/y [B, S, H, P] and Bm/Cm [B, S, G, N] in bf16 or fp32 (all the
// same type), dt [B, S, H] fp32, A [H] fp32, initial/final state
// [B, H, P, N] fp32; all contiguous.  Arithmetic is fp32 throughout.
//
// What bounds it on this card: bytes.  x and y stream through once and B/C
// are shared by all heads of a group, while the per-chunk products do about
// Q (N + P) + 4 N P operations per row, far below the H100's ~295
// operations per byte at the main shape (P 64, N 128, Q 256).  This first
// version is the simple, correct shape of the computation, on CUDA cores:
//   * one block per (P-slice of PW <= 32 channels, head, batch).  y[:, p] and
//     state[p, :] depend only on x[:, p], so the split is exact; it turns the
//     48 heads of a batch-1 prefill at P = 64 into 96 blocks;
//   * a loop inside the block walks the chunks in order, carrying the
//     [PW, N] fp32 state in shared memory: it takes the place of the TPU
//     grid's sequential "arbitrary" chunk axis and VMEM scratch;
//   * the prefix sum of dt * A is one warp's scan in shared memory;
//   * rows are computed in 64 x 64 tiles (C B^T, the decay mask, then the
//     product with dt x), so no [Q, Q] score matrix is held: the largest
//     stage (Q 256, N 128, PW 32) is ~135 KB of dynamic shared memory;
//   * above the diagonal exp(cum_i - cum_j) may overflow: the mask selects
//     before the product, so an inf never meets a 0;
//   * the ragged tail is masked in-kernel (dt = 0 and zero rows of x, B, C
//     past S; no rows written past S), where the TPU wrapper used jnp.pad.
// The tensor-core path (mma.sync / wgmma for C B^T and the state product,
// TMA for the tiles) is later work; the plain version beside the wrapper
// (kernels/ssd_scan.py) repeats this per-chunk algorithm so the arithmetic
// is testable without a card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // rows of a C tile / B tile
constexpr int TY = 16;            // thread grid: TY x TX = 256 threads
constexpr int TX = 16;
constexpr int THREADS = TY * TX;
constexpr int RQ = TILE / TY;     // score rows per thread
constexpr int CK = TILE / TX;     // score columns per thread
constexpr int WS = TILE + 4;      // W row stride: the two row groups of a
                                  // warp land 16 banks apart
constexpr int MAX_Q = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

template <int PW, int N>
size_t smem_bytes(int Q) {
  const int Qp = round_up(Q, TILE);
  return sizeof(float) *
         (size_t(Qp) * 2 + size_t(Qp) * PW + size_t(PW) * (N + 1) +
          size_t(TILE) * (N + 1) * 2 + size_t(TILE) * WS);
}

// Stage rows [r0, r0 + TILE) of a chunk of B or C (row stride G * N) as
// fp32 into a [TILE][N + 1] tile, zero where the row is past the chunk or S.
template <typename T, int N>
__device__ void load_tile(float* dst, const T* src, int r0, int chunk_rows,
                          long row_stride) {
  constexpr int NP = N + 1;
  for (int e = threadIdx.x; e < TILE * N; e += THREADS) {
    const int r = e / N, n = e % N, rr = r0 + r;
    dst[r * NP + n] = rr < chunk_rows ? to_f32(src[rr * row_stride + n])
                                      : 0.f;
  }
}

template <typename T, int PW, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ final_state, int S,
                int H, int G, int P, int Q) {
  constexpr int NP = N + 1;
  constexpr int AD = PW / TX;     // y columns per thread
  const int Qp = round_up(Q, TILE);
  extern __shared__ float smem[];
  float* cum = smem;              // [Qp] running sum of dt * A in the chunk
  float* wts = cum + Qp;          // [Qp] dt, later exp(cum_last - cum_j)
  float* xdt = wts + Qp;          // [Qp][PW] dt_j * x_j
  float* st = xdt + Qp * PW;      // [PW][NP] the carried state
  float* Cs = st + PW * NP;       // [TILE][NP]
  float* Bs = Cs + TILE * NP;     // [TILE][NP]
  float* W = Bs + TILE * NP;      // [TILE][WS] masked, decayed C B^T

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int p0 = blockIdx.x * PW, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const float a_h = A[h];
  const long x_row = long(H) * P;       // stride between positions
  const long bc_row = long(G) * N;
  const T* xb = x + (long(b) * S * H + h) * P + p0;
  T* yb = y + (long(b) * S * H + h) * P + p0;
  const float* dtb = dt + long(b) * S * H + h;
  const T* Bb = Bm + (long(b) * S * G + g) * N;
  const T* Cb = Cm + (long(b) * S * G + g) * N;
  const long st_off = ((long(b) * H + h) * P + p0) * N;

  for (int e = tid; e < PW * N; e += THREADS) {
    const int p = e / N, n = e % N;
    st[p * NP + n] = init != nullptr ? init[st_off + long(p) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int rows = min(Q, S - t0);    // valid rows of this chunk
    __syncthreads();                    // the last chunk's readers are done
    for (int r = tid; r < Qp; r += THREADS) {
      const float d = r < rows ? dtb[long(t0 + r) * H] : 0.f;
      wts[r] = d;
      cum[r] = d * a_h;
    }
    __syncthreads();
    if (tid < 32) {
      // inclusive scan of cum: each lane sums a run of Qp / 32, then the
      // lanes' totals are scanned with shuffles
      const int per = Qp / 32, base = tid * per;
      float run = 0.f;
      for (int i = 0; i < per; ++i) run += cum[base + i];
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float acc = incl - run;
      for (int i = 0; i < per; ++i) {
        acc += cum[base + i];
        cum[base + i] = acc;
      }
    }
    for (int e = tid; e < Qp * PW; e += THREADS) {
      const int r = e / PW, p = e % PW;
      xdt[e] =
          r < rows ? to_f32(xb[long(t0 + r) * x_row + p]) * wts[r] : 0.f;
    }
    __syncthreads();

    const T* Bc = Bb + long(t0) * bc_row;
    const T* Cc = Cb + long(t0) * bc_row;
    for (int i0 = 0; i0 < rows; i0 += TILE) {
      __syncthreads();                  // the previous tile's readers
      load_tile<T, N>(Cs, Cc, i0, rows, bc_row);
      __syncthreads();
      // the carried state's contribution: exp(cum_i) C_i . state[p, :]
      float acc[RQ][AD];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int a = 0; a < AD; ++a) acc[i][a] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float sv[AD];
#pragma unroll
        for (int a = 0; a < AD; ++a) sv[a] = st[(tx + a * TX) * NP + n];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float c = Cs[(ty * RQ + i) * NP + n];
#pragma unroll
          for (int a = 0; a < AD; ++a) acc[i][a] = fmaf(c, sv[a], acc[i][a]);
        }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float d = expf(cum[i0 + ty * RQ + i]);
#pragma unroll
        for (int a = 0; a < AD; ++a) acc[i][a] *= d;
      }

      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        __syncthreads();                // W and Bs readers are done
        load_tile<T, N>(Bs, Bc, j0, rows, bc_row);
        __syncthreads();
        float sc[RQ][CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          float cv[RQ], bv[CK];
#pragma unroll
          for (int i = 0; i < RQ; ++i) cv[i] = Cs[(ty * RQ + i) * NP + n];
#pragma unroll
          for (int j = 0; j < CK; ++j) bv[j] = Bs[(tx + j * TX) * NP + n];
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < CK; ++j)
              sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const int ri = i0 + ty * RQ + i;
#pragma unroll
          for (int j = 0; j < CK; ++j) {
            const int cj = j0 + tx + j * TX;
            // select first: above the diagonal the exponent is positive
            W[(ty * RQ + i) * WS + tx + j * TX] =
                ri >= cj ? sc[i][j] * expf(cum[ri] - cum[cj]) : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < TILE; ++j) {
          float xv[AD];
#pragma unroll
          for (int a = 0; a < AD; ++a) xv[a] = xdt[(j0 + j) * PW + tx + a * TX];
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float w = W[(ty * RQ + i) * WS + j];
#pragma unroll
            for (int a = 0; a < AD; ++a) acc[i][a] = fmaf(w, xv[a], acc[i][a]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = i0 + ty * RQ + i;
        if (r >= rows) continue;
        T* yr = yb + long(t0 + r) * x_row;
#pragma unroll
        for (int a = 0; a < AD; ++a) store(yr + tx + a * TX, acc[i][a]);
      }
    }

    // state' = exp(cum_last) state + sum_j exp(cum_last - cum_j) xdt_j B_j^T
    // (past the valid rows dt = 0, so cum_last = cum[Qp - 1])
    const float cum_last = cum[Qp - 1];
    __syncthreads();                    // every y tile has read st
    for (int r = tid; r < Qp; r += THREADS) wts[r] = expf(cum_last - cum[r]);
    const float chunk_decay = expf(cum_last);
    for (int j0 = 0; j0 < rows; j0 += TILE) {  // rows past: xdt = 0
      __syncthreads();
      load_tile<T, N>(Bs, Bc, j0, rows, bc_row);
      __syncthreads();
      for (int e = tid; e < PW * N; e += THREADS) {
        const int p = e / N, n = e % N;
        float s = st[p * NP + n];
        if (j0 == 0) s *= chunk_decay;
#pragma unroll 8
        for (int j = 0; j < TILE; ++j)
          s = fmaf(wts[j0 + j] * xdt[(j0 + j) * PW + p], Bs[j * NP + n], s);
        st[p * NP + n] = s;
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < PW * N; e += THREADS) {
    const int p = e / N, n = e % N;
    final_state[st_off + long(p) * N + n] = st[p * NP + n];
  }
}

template <typename T, int PW, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* init, void* y,
                   void* final_state, int B, int S, int H, int G, int P,
                   int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes<PW, N>(Q);
  auto kernel = ssd_scan_kernel<T, PW, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(P / PW, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(final_state), S, H, G, P, Q);
  return cudaGetLastError();
}

template <typename T, int PW>
cudaError_t by_state_dim(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, const void* init,
                         void* y, void* final_state, int B, int S, int H,
                         int G, int P, int N, int Q, cudaStream_t st) {
  switch (N) {
    case 16:
      return launch<T, PW, 16>(x, dt, A, Bm, Cm, init, y, final_state, B, S,
                               H, G, P, Q, st);
    case 32:
      return launch<T, PW, 32>(x, dt, A, Bm, Cm, init, y, final_state, B, S,
                               H, G, P, Q, st);
    case 64:
      return launch<T, PW, 64>(x, dt, A, Bm, Cm, init, y, final_state, B, S,
                               H, G, P, Q, st);
    case 128:
      return launch<T, PW, 128>(x, dt, A, Bm, Cm, init, y, final_state, B,
                                S, H, G, P, Q, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* init, void* y, void* final_state,
             int B, int S, int H, int G, int P, int N, int Q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || Q < 1 || Q > MAX_Q)
    return int(cudaErrorInvalidValue);
  switch (P) {
    case 16:
      return int(by_state_dim<T, 16>(x, dt, A, Bm, Cm, init, y, final_state,
                                     B, S, H, G, P, N, Q, st));
    case 32:
    case 64:
    case 128:
      return int(by_state_dim<T, 32>(x, dt, A, Bm, Cm, init, y, final_state,
                                     B, S, H, G, P, N, Q, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* init,
                             void* y, void* final_state, int B, int S, int H,
                             int G, int P, int N, int Q, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, final_state, B,
                                 S, H, G, P, N, Q, stream);
}

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* init,
                            void* y, void* final_state, int B, int S, int H,
                            int G, int P, int N, int Q, void* stream) {
  return dispatch<float>(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, G,
                         P, N, Q, stream);
}

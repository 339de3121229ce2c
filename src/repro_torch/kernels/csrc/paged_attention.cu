// Decode attention over a paged KV cache for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// paged_attention_kernel (body _kernel).  Same function: one query token per
// sequence attends over its KV pages, found through a page table; lengths[b]
// masks sequence b; the G query heads of a KV group share each loaded K/V
// row; online softmax in fp32 across the sequence; optional tanh softcap.
//
// Layouts: q/out [B, H, D]; k/v pages [P, ps, KVH, D], all contiguous;
// page_tables [B, maxp] int32; lengths [B] int32.  bf16 or fp32 in, fp32
// scores / m / l / acc, output in q's type.
//
// What bounds it on this card: bytes.  Each K/V row is used for only G
// multiply-adds per element, so decode streams the cache at a handful of
// FLOPs per byte, far below the H100's ~295 FLOP/byte ridge, and no tensor
// core helps.  Reaching the bytes' bound takes many loads in flight: one
// block per (sequence, KV head) would be 64 blocks at olmo-1b's batch of 4
// on 132 SMs, each walking a whole sequence alone.  The design:
//   * split over the sequence: one block per (split, KV head, sequence).
//     The wrapper's plan (kernels/paged_attention.py: split_plan) cuts the
//     capacity maxp * ps into n_split ranges of `span` tokens from the shapes
//     alone, never from lengths, so the host never waits on the card;
//   * no shared-memory staging: a group of LPT lanes takes one token, a
//     16-byte slice of D a lane.  A row holds SL = D * sizeof(T) / 16
//     slices; LPT is SL rounded up to a power of two, at most 32 (16 lanes
//     at D = 128 in bf16, so a warp scores two tokens at once; a whole warp
//     at D = 256, where an fp32 lane takes two slices 128 elements apart).
//     At D = 192 a row is 24 slices in bf16 and 48 in fp32, and 24 lanes a
//     token do not tile a warp: a whole warp takes the token, and the lanes
//     whose slice lies past the row (8 of 32 in bf16; 16 of 32 on an fp32
//     lane's second slice) load nothing and hold zeros.  So each lane keeps
//     the D = 128 and 256 variants' 8 elements of q and of each
//     accumulator, and their registers, where 8 lanes of three 16-byte
//     slices would hold 24 and 16 lanes of three 8-byte slices 12; the
//     idle lanes cost FMA slots, which the bytes' bound leaves free.  The dot product reduces by shuffles within the
//     group.  Every lane group scores its tokens for the G query heads
//     (in chunks of at most 8, whose q slices live in registers) and keeps
//     its own online softmax (m, l) and fp32 accumulator slice in
//     registers.  A lane issues the K and V loads of U tokens (4, or 2
//     when G > 2) before it uses the first: 2 * U 16-byte loads in flight
//     (twice that for fp32 at 256);
//   * the lane groups of a warp merge by shuffles, the warps of a block once
//     through shared memory;
//   * combine in the same launch: with n_split > 1 each block writes its
//     partial (m, l, acc[D]) to scratch, fences, and draws a ticket for its
//     (sequence, KV head); the block that draws the last merges the n_split
//     partials with exp2(m_i - M) weights, writes the output and resets the
//     ticket to 0 for the next launch on its stream.  A second combining
//     kernel would cost a launch a layer on a decode step bound by the host's
//     launches.  With n_split == 1 the block writes the output directly.
// A split past a sequence's end leaves m = NEG_INF, l = 0, acc = 0, and the
// merge guards its denominator with fmaxf(L, 1e-30f), as the unsplit kernel
// did, so a length of 0 gives zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;             // warps a block
constexpr int THREADS = 32 * NW;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Eight bf16 or four fp32 values of one 16-byte load, widened to fp32.
__device__ __forceinline__ void widen(const uint4& raw, float* out,
                                      const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen(const uint4& raw, float* out,
                                      const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Lanes that take one token: the row's SL 16-byte slices rounded up to a
// power of two, at most a warp (a row of more than 32 slices takes several
// a lane).
__host__ __device__ constexpr int lanes_a_token(int sl) {
  return sl > 16 ? 32 : sl > 8 ? 16 : sl > 4 ? 8 : 4;
}

// Is a lane's slice `slice` inside the row?  Always, where LPT divides SL.
template <bool FULL, int SL>
__device__ __forceinline__ bool live(int slice) {
  return FULL || slice < SL;
}

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ page_tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       float* __restrict__ scratch, int* __restrict__ tickets,
                       int H, int KVH, int ps, int maxp, int span,
                       float scale, float softcap) {
  constexpr int VEC = 16 / int(sizeof(T));  // elements a 16-byte load
  constexpr int SL = D / VEC;           // 16-byte slices a row
  constexpr int LPT = lanes_a_token(SL);
  constexpr int NV = (SL + LPT - 1) / LPT;  // 16-byte loads a lane a row
  constexpr int EL = NV * VEC;          // elements a lane holds; its load i
                                        // is slice i * LPT + sub, elements
                                        // (i * LPT + sub) * VEC + [0, VEC),
                                        // live if that slice is below SL
  constexpr bool FULL = SL % LPT == 0;  // every lane's every slice live
  static_assert(D % VEC == 0 && SL >= 4, "paged_attention: head_dim");
  constexpr int TPW = 32 / LPT;         // tokens a warp scores at once
  constexpr int STEP = NW * TPW;        // tokens a block scores at once
  constexpr int U = GMAX >= 4 ? 2 : 4;  // tokens a lane group loads ahead
  extern __shared__ float smem[];
  float* sm_acc = smem;                 // [NW][GMAX][D]
  float* sm_m = sm_acc + NW * GMAX * D; // [NW][GMAX]
  float* sm_l = sm_m + NW * GMAX;       // [NW][GMAX]

  const int split = blockIdx.x, n_split = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPT, sub = lane % LPT;
  const int G = H / KVH;
  const int n_tok = min(lengths[b], maxp * ps);
  const int t_begin = split * span;
  const int t_end = min(t_begin + span, n_tok);
  const int* pt = page_tables + long(b) * maxp;
  const long page_stride = long(ps) * KVH * D;
  const long row_stride = long(KVH) * D;
  const long head_off = long(kvh) * D + sub * VEC;
  const float qk_scale = softcap > 0.f ? scale : scale * LOG2E;
  const long part = (long(b) * KVH + kvh) * n_split;   // this (b, kvh)
  // partials (n_split > 1): acc [B, KVH, n_split, G, D], then m and l
  // [B, KVH, n_split, G, 2], all fp32
  float* p_acc = scratch;
  float* p_ml = scratch + long(B) * KVH * n_split * G * D;

  for (int g0 = 0; g0 < G; g0 += GMAX) {
    float qv[GMAX][EL], acc[GMAX][EL], m[GMAX], l[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const bool ok = g0 + g < G;
      const T* qh = q + (long(b) * H + kvh * G + g0 + g) * D + sub * VEC;
#pragma unroll
      for (int u = 0; u < EL; ++u) {
        qv[g][u] = ok && live<FULL, SL>((u / VEC) * LPT + sub)
                       ? to_f32(qh[(u / VEC) * LPT * VEC + u % VEC]) * qk_scale
                       : 0.f;
        acc[g][u] = 0.f;
      }
      m[g] = NEG_INF;
      l[g] = 0.f;
    }

    // the block's tokens: base tb + u * STEP + warp * TPW + grp.  The loop
    // bound is uniform over the block, so every lane meets every shuffle.
    for (int tb = t_begin; tb < t_end; tb += U * STEP) {
      uint4 kr[U][NV], vr[U][NV];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = tb + u * STEP + warp * TPW + grp;
        ok[u] = t < t_end;
        const long off = ok[u] ? long(__ldg(pt + t / ps)) * page_stride +
                                     long(t % ps) * row_stride + head_off
                               : 0;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          if (ok[u] && live<FULL, SL>(i * LPT + sub)) {
            const long at = off + i * LPT * VEC;
            kr[u][i] = __ldg(reinterpret_cast<const uint4*>(k_pages + at));
            vr[u][i] = __ldg(reinterpret_cast<const uint4*>(v_pages + at));
          } else {
            kr[u][i] = vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      float sc[U][GMAX];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[EL];
#pragma unroll
        for (int i = 0; i < NV; ++i) widen(kr[u][i], kf + i * VEC, k_pages);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EL; ++e) s = fmaf(qv[g][e], kf[e], s);
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap * LOG2E;
          sc[u][g] = ok[u] ? s : NEG_INF;
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
        const float alpha = exp2f(m[g] - mx);
        m[g] = mx;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[EL];
#pragma unroll
        for (int i = 0; i < NV; ++i) widen(vr[u][i], vf + i * VEC, v_pages);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          const float p = ok[u] ? exp2f(sc[u][g] - m[g]) : 0.f;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < EL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }

    // merge the TPW lane groups of the warp (lanes sub, sub + LPT, ...)
#pragma unroll
    for (int o = LPT; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mx = fmaxf(m[g], m_o);
        const float a = exp2f(m[g] - mx), c = exp2f(m_o - mx);
        m[g] = mx;
        l[g] = l[g] * a + l_o * c;
#pragma unroll
        for (int e = 0; e < EL; ++e)
          acc[g][e] = acc[g][e] * a +
                      __shfl_xor_sync(0xffffffffu, acc[g][e], o) * c;
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
#pragma unroll
        for (int e = 0; e < EL; ++e)
          if (live<FULL, SL>((e / VEC) * LPT + sub))
            sm_acc[(warp * GMAX + g) * D + ((e / VEC) * LPT + sub) * VEC +
                   e % VEC] = acc[g][e];
        if (sub == 0) {
          sm_m[warp * GMAX + g] = m[g];
          sm_l[warp * GMAX + g] = l[g];
        }
      }
    }
    __syncthreads();

    // merge the warps: one thread an output element
    for (int e = tid; e < GMAX * D; e += THREADS) {
      const int g = e / D, d = e % D;
      if (g0 + g >= G) continue;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * GMAX + g]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = exp2f(sm_m[w * GMAX + g] - mx);
        L += sm_l[w * GMAX + g] * c;
        A += sm_acc[(w * GMAX + g) * D + d] * c;
      }
      const int h = g0 + g;
      if (n_split == 1) {
        store(out + (long(b) * H + kvh * G + h) * D + d, A / fmaxf(L, 1e-30f));
      } else {
        const long i = (part + split) * G + h;
        p_acc[i * D + d] = A;
        if (d == 0) {
          p_ml[2 * i] = mx;
          p_ml[2 * i + 1] = L;
        }
      }
    }
    __syncthreads();              // shared memory free for the next chunk
  }
  if (n_split == 1) return;

  // combine: the last of the n_split blocks of (b, kvh) merges the partials
  __shared__ bool last;
  __threadfence();                // this block's partials, visible to all
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(tickets + long(b) * KVH + kvh, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < G * D; e += THREADS) {
    const int h = e / D, d = e % D;
    float mx = NEG_INF;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, __ldcg(p_ml + 2 * ((part + s) * G + h)));
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long i = (part + s) * G + h;
      const float c = exp2f(__ldcg(p_ml + 2 * i) - mx);
      L += __ldcg(p_ml + 2 * i + 1) * c;
      A += __ldcg(p_acc + i * D + d) * c;
    }
    store(out + (long(b) * H + kvh * G + h) * D + d, A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) tickets[long(b) * KVH + kvh] = 0;   // ready for the next
}

template <typename T, int D, int GMAX>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_tables, const void* lengths, void* out,
                   void* scratch, void* tickets, int B, int H, int KVH,
                   int ps, int maxp, int n_split, int span, float scale,
                   float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * size_t(NW) * GMAX * (D + 2);
  auto kernel = paged_attention_kernel<T, D, GMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, KVH, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(scratch), static_cast<int*>(tickets), H, KVH, ps,
      maxp, span, scale, softcap);
  return cudaGetLastError();
}

// q heads a KV group handled at once: the smallest power of two >= G, up
// to 8 (a larger group runs in chunks of 8).
template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* k_pages,
                     const void* v_pages, const void* page_tables,
                     const void* lengths, void* out, void* scratch,
                     void* tickets, int B, int H, int KVH, int ps, int maxp,
                     int n_split, int span, float scale, float softcap,
                     cudaStream_t st) {
  if (G <= 1)
    return launch<T, D, 1>(q, k_pages, v_pages, page_tables, lengths, out,
                           scratch, tickets, B, H, KVH, ps, maxp, n_split,
                           span, scale, softcap, st);
  if (G <= 2)
    return launch<T, D, 2>(q, k_pages, v_pages, page_tables, lengths, out,
                           scratch, tickets, B, H, KVH, ps, maxp, n_split,
                           span, scale, softcap, st);
  if (G <= 4)
    return launch<T, D, 4>(q, k_pages, v_pages, page_tables, lengths, out,
                           scratch, tickets, B, H, KVH, ps, maxp, n_split,
                           span, scale, softcap, st);
  return launch<T, D, 8>(q, k_pages, v_pages, page_tables, lengths, out,
                         scratch, tickets, B, H, KVH, ps, maxp, n_split, span,
                         scale, softcap, st);
}

template <typename T>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* page_tables, const void* lengths, void* out,
             void* scratch, void* tickets, int B, int H, int KVH, int D,
             int ps, int maxp, int n_split, int span, float scale,
             float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
  switch (D) {
    case 32:
      return launch_g<T, 32>(G, q, k_pages, v_pages, page_tables, lengths,
                             out, scratch, tickets, B, H, KVH, ps, maxp,
                             n_split, span, scale, softcap, st);
    case 64:
      return launch_g<T, 64>(G, q, k_pages, v_pages, page_tables, lengths,
                             out, scratch, tickets, B, H, KVH, ps, maxp,
                             n_split, span, scale, softcap, st);
    case 128:
      return launch_g<T, 128>(G, q, k_pages, v_pages, page_tables, lengths,
                              out, scratch, tickets, B, H, KVH, ps, maxp,
                              n_split, span, scale, softcap, st);
    case 192:
      return launch_g<T, 192>(G, q, k_pages, v_pages, page_tables, lengths,
                              out, scratch, tickets, B, H, KVH, ps, maxp,
                              n_split, span, scale, softcap, st);
    case 256:
      return launch_g<T, 256>(G, q, k_pages, v_pages, page_tables, lengths,
                              out, scratch, tickets, B, H, KVH, ps, maxp,
                              n_split, span, scale, softcap, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// scratch: n_split > 1 only, B * KVH * n_split * G * (D + 2) fp32;
// tickets: n_split > 1 only, B * KVH int32, all 0 (each launch leaves them
// 0).  Either may be NULL when n_split == 1.
extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const void* page_tables,
                                    const void* lengths, void* out,
                                    void* scratch, void* tickets, int B,
                                    int H, int KVH, int D, int ps, int maxp,
                                    int n_split, int span, float scale,
                                    float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, page_tables, lengths,
                                 out, scratch, tickets, B, H, KVH, D, ps,
                                 maxp, n_split, span, scale, softcap, stream);
}

extern "C" int paged_attention_f32(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* page_tables,
                                   const void* lengths, void* out,
                                   void* scratch, void* tickets, int B,
                                   int H, int KVH, int D, int ps, int maxp,
                                   int n_split, int span, float scale,
                                   float softcap, void* stream) {
  return dispatch<float>(q, k_pages, v_pages, page_tables, lengths, out,
                         scratch, tickets, B, H, KVH, D, ps, maxp, n_split,
                         span, scale, softcap, stream);
}

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
// [B, H, P, N] fp32; all contiguous.  The bf16 path also takes a workspace:
// dS_c [B, nc, H, P, N] fp32, S_{c-1} as two bf16 tiles of [P, N] for each
// (batch, chunk, head), then cum and dt [B, H, nc, Q] fp32 each, nc the
// number of chunks (kernels/ssd_scan.py sizes it).
//
// What bounds it on this card: bytes.  x and y stream through once and B/C
// are shared by all heads of a group, while the chunk products do about
// Q (N + P) + 4 N P operations per row, far below the H100's ~295
// operations per byte (P 64, N 128, Q 256 at mamba2-780m's prefill).  What
// held the first port of this kernel (one block per (32 channels, head,
// batch) walking the chunks in order, fp32 FMAs on CUDA cores) at 136x that
// bound was too few blocks and the chunks in series.  bf16 (the model's
// type) now runs the SSD decomposition of arXiv:2405.21060 sections 6-7 as
// three launches on the current stream, every product on wgmma:
//   1. ssd_chunk_state, one warpgroup per (chunk, 64 state columns, head,
//      batch): the chunk's cum (one warp's scan of dt * A), and its own
//      state contribution dS_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T,
//      a [P x Q] by [Q x 64] product with the chunk's B rows in shared
//      memory.  Writes dS_c, cum (log2 units) and dt to the workspace;
//   2. ssd_state_pass, elementwise over [B, H, P, N]: the only sequential
//      part, S_c = exp(cum_last_c) S_{c-1} + dS_c over the chunks, in fp32
//      registers.  It writes each S_{c-1} as step 3's operand, bf16 high
//      and low tiles in the swizzled layout, and the final state;
//   3. ssd_chunk_scan, one warpgroup per (64-row tile i of a chunk, head,
//      batch), as flash_attention's (q tile, head, batch), the longest rows
//      first: y = diag(exp(cum_i)) C_i S_{c-1}^T, then for every tile j <= i
//      of the chunk W = (C_i B_j^T) o exp(cum_i - cum_j) o dt_j, masked to
//      j <= i before the exp (above the diagonal the exponent is positive and
//      may overflow), and y += W x_j.  C_i, S_{c-1}'s tiles and tile 0 arrive
//      in one cp.async group; B_j and x_j then come through a two-stage ring
//      in the swizzled layout the descriptors read, its second stage reusing
//      S_{c-1}'s bytes (74 KB a block, three an SM); W goes from the
//      accumulators into A registers as flash packs P.
// At the main shape that is 384 + 672 blocks where the first port had 96.
// What holds it back now (in-kernel clock64 stamps on an H100): the bytes
// each block pulls from L2 into shared memory (B_j and C_i again for every
// head, S_{c-1} again for every row tile) and the wait on each product
// before the next: step 3 runs in two waves of ~10 us blocks.
// Numbers.  A product rounds its operands to bf16; the plain version keeps
// fp32.  Each product here has one operand that arrives exactly in bf16 (x,
// B or C).  The other one is fp32 (the decayed dt x weights of step 1, the
// carried state S_{c-1}, W) and is split into a bf16 high part and the bf16
// low part of what is left: two products into one fp32 accumulator, about 16
// bits of mantissa for twice the tensor work (the kernel is bound by bytes,
// not operations).  dt and the decays stay out of x: they go into the split
// operand or into fp32 row scales of the accumulator.  The carried state
// lives in fp32 only.  tests/test_torch_ssd.py emulates this rounding on the
// CPU (ssd_scan_plain with split=split_bf16).
// Registers: C_i's A fragments are read from shared memory again at every
// tile (a fragment carried across tiles shared registers with another in
// flash_attention.cu, see its header); only y's accumulator lives across
// tiles.  No wgmma is issued under a condition: ptxas then fences them.
// fp32 keeps the CUDA-core kernel of the first port, ssd_scan_simt: on the
// tensor cores fp32 would run in TF32 (about 3 digits), and the fp32 path is
// held to 1e-3.  The model runs in bf16, so the main path never reaches it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "ssd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;          // rows of a C, B or x tile: wgmma's M
constexpr int WG = 128;           // a warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------- bf16: the tensor cores

// Step 1 splits the state dim N over blocks of NB columns, for more blocks
// and less shared memory a block.
template <int N>
__host__ __device__ constexpr int state_cols() { return N > 64 ? 64 : N; }

// Step 1's shared memory: the chunk's B rows, NB columns of them (the
// N-major operand of dS_c), its x rows padded for scalar reads, cum and the
// row weights.
template <int P, int NB>
struct StateSmem {
  using BT = SwTile<MAX_Q, NB>;
  static constexpr int XS = P + 8;                 // x row stride, elements
  static constexpr int X_OFF = BT::BYTES;
  static constexpr int CUM_OFF = X_OFF + MAX_Q * XS * 2;
  static constexpr int BYTES = CUM_OFF + 2 * MAX_Q * 4;
};

// Step 1: one warpgroup per (chunk and NB state columns, head, batch).
// dS_c[p, n] = sum_j w_j x_j[p] B_j[n] with w_j = exp(cum_last - cum_j)
// dt_j: A = (w x)^T from registers, split into high and low parts; B the
// chunk's B rows, exact (chunk_state_product, ssd_common.cuh).
template <int P, int N>
__global__ void __launch_bounds__(WG)
ssd_chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ cum_ws,
                float* __restrict__ dt_ws, int S, int H, int G, int Q) {
  constexpr int NB = state_cols<N>(), SPLIT = N / NB;
  using L = StateSmem<P, NB>;
  using BT = typename L::BT;
  constexpr int XS = L::XS;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Bs = smem;
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::X_OFF);
  float* cum = reinterpret_cast<float*>(smem + L::CUM_OFF);    // [MAX_Q]
  float* wts = cum + MAX_Q;                                    // [MAX_Q]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nc = gridDim.x / SPLIT, c = blockIdx.x / SPLIT;
  const int n0 = (blockIdx.x % SPLIT) * NB, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, rows = min(Q, S - t0);
  // the product's depth, in whole groups of four k-steps: wgmma issued
  // under a condition makes ptxas serialise it
  const int kq = round_up(rows, 64);
  const long x_row = long(H) * P, bc_row = long(G) * N;
  const bf16* xb = x + ((long(b) * S + t0) * H + h) * P;
  const bf16* Bb = Bm + ((long(b) * S + t0) * G + h / (H / G)) * N + n0;

  // this thread's rows of dt first: their latency overlaps the copies
  const int qs = round_up(Q, 64);            // >= kq; at most 2 WG
  const float a_h = A[h];
  float d_own[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tid + i * WG;
    d_own[i] = r < rows ? dt[(long(b) * S + t0 + r) * H + h] : 0.f;
  }
  // B and x rows [0, kq), zero at and past `rows`
  for (int e = tid; e < kq * (NB / 8); e += WG) {
    const int r = e / (NB / 8), ch = e % (NB / 8);
    const bool ok = r < rows;
    cp_async16(smem_addr(Bs + BT::offset(r, ch)),
               ok ? Bb + r * bc_row + ch * 8 : Bb, ok);
  }
  for (int e = tid; e < kq * (P / 8); e += WG) {
    const int r = e / (P / 8), ch = e % (P / 8);
    const bool ok = r < rows;
    cp_async16(smem_addr(Xs + r * XS + ch * 8),
               ok ? xb + r * x_row + ch * 8 : xb, ok);
  }
  cp_async_commit();

  // cum: the prefix sum of dt * A.  dt = 0 past `rows`, so the rows there
  // hold cum_last and weigh nothing.
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
  const long ws_row = ((long(b) * H + h) * nc + c) * Q;
  for (int r = tid; r < qs; r += WG) {
    const float d = wts[r];
    if (r < Q && n0 == 0) {
      cum_ws[ws_row + r] = cum[r] * LOG2E;
      dt_ws[ws_row + r] = d;
    }
    wts[r] = expf(last - cum[r]) * d;
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float* out = states + ((long(b) * nc + c) * H + h) * long(P) * N + n0;
  chunk_state_product<P, N, NB, XS>(Xs, wts, smem_addr(Bs), kq, out);
}

// Step 2: one thread per 4 consecutive (p, n) of one (batch, head).
// S_c = exp(cum_last_c) S_{c-1} + dS_c over the chunks, in fp32 registers.
// Each S_{c-1} is written for step 3 as the operand it multiplies: its bf16
// high and low tiles, each in the swizzled layout of SwTile<P, N>, so that
// step 3 copies them straight into shared memory.
template <int P, int N>
__global__ void __launch_bounds__(256)
ssd_state_pass(const float* __restrict__ states,
               const float* __restrict__ cum_ws,
               const float* __restrict__ init,
               unsigned char* __restrict__ prev,
               float* __restrict__ final_state, int H, int Q, int nc,
               long total) {
  using ST = SwTile<P, N>;
  constexpr int PN = P * N;
  const long i = long(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long bh = i / (PN / 4);
  const int e = int(i % (PN / 4)) * 4;
  const long b = bh / H, h = bh % H;
  // bytes of (row p, columns n .. n + 3) in the swizzled tiles
  const int off = ST::offset(e / N, (e % N) / 8) + (e % 8) * 2;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (init != nullptr) {          // the caller's tensor: no alignment assumed
    const float* ip = init + bh * PN + e;
    s = make_float4(ip[0], ip[1], ip[2], ip[3]);
  }
  for (int c = 0; c < nc; ++c) {
    const long slot = (b * nc + c) * H + h;
    const float4 d =
        *reinterpret_cast<const float4*>(states + slot * PN + e);
    uint2 hi, lo;
    split_bf16(s.x, s.y, hi.x, lo.x);
    split_bf16(s.z, s.w, hi.y, lo.y);
    unsigned char* tiles = prev + slot * (2 * ST::BYTES);
    *reinterpret_cast<uint2*>(tiles + off) = hi;
    *reinterpret_cast<uint2*>(tiles + ST::BYTES + off) = lo;
    const float decay = exp2f(cum_ws[(bh * nc + c) * Q + Q - 1]);
    s = make_float4(fmaf(decay, s.x, d.x), fmaf(decay, s.y, d.y),
                    fmaf(decay, s.z, d.z), fmaf(decay, s.w, d.w));
  }
  *reinterpret_cast<float4*>(final_state + bh * PN + e) = s;
}

// Step 3's shared memory: a two-stage ring of B_j and x_j tiles, where the
// second stage's bytes first hold S_{c-1}'s high and low tiles (read once,
// before that stage fills), C_i, cum and dt of the chunk's rows.  At
// mamba2-780m's widths that is 74 KB, three blocks an SM.
template <int P, int N>
struct ScanSmem {
  using BT = SwTile<TILE, N>;     // B_j: K-major operand of C_i B_j^T
  using XT = SwTile<TILE, P>;     // x_j: N-major operand of W x_j
  using ST = SwTile<P, N>;        // S_{c-1}: K-major operand of C_i S^T
  using CT = SwTile<TILE, N>;     // C_i: A operand, read with ldmatrix
  static constexpr int S_BYTES = round_up(ST::BYTES, 1024);
  static constexpr int B_BYTES = round_up(BT::BYTES, 1024);
  static constexpr int STAGE = B_BYTES + round_up(XT::BYTES, 1024);
  static constexpr int C_OFF =
      STAGE + (STAGE > 2 * S_BYTES ? STAGE : 2 * S_BYTES);
  static constexpr int CUM_OFF = C_OFF + round_up(CT::BYTES, 1024);
  static constexpr int BYTES = CUM_OFF + 2 * MAX_Q * 4;
};

// Step 3: one warpgroup per (64-row tile of a chunk, head, batch).
template <int P, int N>
__global__ void __launch_bounds__(WG)
ssd_chunk_scan(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm,
               const unsigned char* __restrict__ prev,
               const float* __restrict__ cum_ws,
               const float* __restrict__ dt_ws, bf16* __restrict__ y, int S,
               int H, int G, int Q) {
  using L = ScanSmem<P, N>;
  using BT = typename L::BT;
  using XT = typename L::XT;
  using ST = typename L::ST;
  using CT = typename L::CT;
  constexpr int KN = N / 16, NY = P / 8, NW = TILE / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;                 // stage: B_j, then x_j
  unsigned char* S_hi = smem + L::STAGE;      // until stage 1 fills
  unsigned char* S_lo = S_hi + L::S_BYTES;
  unsigned char* Cs = smem + L::C_OFF;
  float* cum = reinterpret_cast<float*>(smem + L::CUM_OFF);  // log2 units
  float* dts = cum + MAX_Q;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int nc = gridDim.x, c = blockIdx.x, h = blockIdx.y;
  const int n_tiles = (Q + TILE - 1) / TILE;
  const int batch = gridDim.z / n_tiles;
  const int ti = n_tiles - 1 - blockIdx.z / batch, b = blockIdx.z % batch;
  const int t0 = c * Q, rows = min(Q, S - t0), i0 = ti * TILE;
  if (i0 >= rows) return;                 // past the last chunk's rows
  const long x_row = long(H) * P, bc_row = long(G) * N;
  const long bc_off = ((long(b) * S + t0) * G + h / (H / G)) * N;
  const bf16* xb = x + ((long(b) * S + t0) * H + h) * P;
  const bf16* Bb = Bm + bc_off;
  const bf16* Cb = Cm + bc_off;

  auto issue = [&](int tj) {
    if (tj <= ti) {
      unsigned char* st = ring + (tj % 2) * L::STAGE;
      const int j0 = tj * TILE;
      load_sw_tile<TILE, N, WG>(st, Bb + j0 * bc_row, bc_row, rows - j0,
                                tid);
      load_sw_tile<TILE, P, WG>(st + L::B_BYTES, xb + j0 * x_row, x_row,
                                rows - j0, tid);
    }
    cp_async_commit();
  };
  // one group: C_i, S_{c-1}'s tiles (as step 2 laid them out) and tile 0
  load_sw_tile<TILE, N, WG>(Cs, Cb + i0 * bc_row, bc_row, rows - i0, tid);
  const unsigned char* sp =
      prev + ((long(b) * nc + c) * H + h) * (2 * ST::BYTES);
  for (int e = tid; e < ST::BYTES / 16; e += WG) {
    cp_async16(smem_addr(S_hi + 16 * e), sp + 16 * e, true);
    cp_async16(smem_addr(S_lo + 16 * e), sp + ST::BYTES + 16 * e, true);
  }
  issue(0);

  // cum and dt of rows [0, i0 + 64); rows past Q take cum_last (so every
  // decay stays finite) and dt 0
  const long ws_row = ((long(b) * H + h) * nc + c) * Q;
  for (int r = tid; r < i0 + TILE; r += WG) {
    cum[r] = cum_ws[ws_row + min(r, Q - 1)];
    dts[r] = r < Q ? dt_ws[ws_row + r] : 0.f;
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // C_i's A fragments: ldmatrix.x4 of rows row0 + [0, 16), columns
  // 16 kk + [0, 16); each lane gives one row's 16-byte chunk
  const int row0 = warp * 16;
  const int a_row = row0 + (lane % 8) + 8 * ((lane / 8) % 2);
  const uint32_t Cbase = smem_addr(Cs);
  auto c_frag = [&](int kk) {
    return Cbase + CT::offset(a_row, 2 * kk + lane / 16);
  };
  // y = C_i S_{c-1}^T (high, then low part), then each row times exp(cum_i)
  float acc[NY][4];
  {
    uint32_t cf[KN][4];
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) ldmatrix_x4(cf[kk], c_frag(kk));
    const uint32_t Sh = smem_addr(S_hi), Sl = smem_addr(S_lo);
    fence_regs(cf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      wgmma_rs<0>(acc, cf[kk], ST::k_major(Sh, kk), kk > 0);
      wgmma_rs<0>(acc, cf[kk], ST::k_major(Sl, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(cf);
  }
  const int ra = i0 + row0 + g, rb = ra + 8;  // chunk rows of acc[.][0|2]
  const float cum_a = cum[ra], cum_b = cum[rb];
  {
    const float ea = ex2(cum_a), eb = ex2(cum_b);
#pragma unroll
    for (int n = 0; n < NY; ++n) {
      acc[n][0] *= ea;
      acc[n][1] *= ea;
      acc[n][2] *= eb;
      acc[n][3] *= eb;
    }
  }

  for (int tj = 0; tj <= ti; ++tj) {
    // tile tj has landed; after the barrier tile tj-1's stage (at tj = 0,
    // S_{c-1}'s tiles) is free
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    issue(tj + 1);
    const unsigned char* st = ring + (tj % 2) * L::STAGE;
    const uint32_t Ba = smem_addr(st), Xa = smem_addr(st + L::B_BYTES);

    // C_i B_j^T: 64 rows i x 64 rows j, C_i's fragments read again
    uint32_t cf[KN][4];
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) ldmatrix_x4(cf[kk], c_frag(kk));
    float s[NW][4];
    fence_regs(cf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
      wgmma_rs<0>(s, cf[kk], BT::k_major(Ba, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(cf);

    // W = (C_i B_j^T) o 2^(cum_i - cum_j) o dt_j; on the diagonal tile the
    // mask selects j <= i before the exp.  (Below it j < i0 <= i.)
    const int j0 = tj * TILE;
    const bool diag = tj == ti;
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + 2 * q + (e & 1);
        const bool lower = e < 2;
        const bool ok = !diag || j <= (lower ? ra : rb);
        s[n][e] = ok ? s[n][e] * ex2((lower ? cum_a : cum_b) - cum[j]) *
                           dts[j]
                     : 0.f;
      }
    // W's A fragments for rows j kk*16 + [0, 16), high and low parts
    uint32_t wh[TILE / 16][4], wl[TILE / 16][4];
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      split_bf16(s[2 * kk][0], s[2 * kk][1], wh[kk][0], wl[kk][0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], wh[kk][1], wl[kk][1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], wh[kk][2], wl[kk][2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], wh[kk][3], wl[kk][3]);
    }
    fence_regs(acc);
    fence_regs(wh);
    fence_regs(wl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint64_t desc = XT::n_major(Xa, kk);
      wgmma_rs<1>(acc, wh[kk], desc, 1);
      wgmma_rs<1>(acc, wl[kk], desc, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(wh);
    fence_regs(wl);
  }
  cp_async_wait<0>();                     // the last, empty group

  bf16* yb = y + ((long(b) * S + t0) * H + h) * P;
#pragma unroll
  for (int n = 0; n < NY; ++n) {
    const int col = n * 8 + 2 * q;
    if (ra < rows)
      *reinterpret_cast<uint32_t*>(yb + ra * x_row + col) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (rb < rows)
      *reinterpret_cast<uint32_t*>(yb + rb * x_row + col) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int P, int N>
cudaError_t launch_wgmma(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, const void* init,
                         void* y, void* final_state, void* ws, int B, int S,
                         int H, int G, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q, n_tiles = (Q + TILE - 1) / TILE;
  float* states = static_cast<float*>(ws);
  unsigned char* prev =
      reinterpret_cast<unsigned char*>(states + long(B) * nc * H * P * N);
  float* cum_ws = states + 2 * long(B) * nc * H * P * N;
  float* dt_ws = cum_ws + long(B) * H * nc * Q;
  const bf16* xh = static_cast<const bf16*>(x);
  const bf16* Bh = static_cast<const bf16*>(Bm);
  constexpr int split = N / state_cols<N>();   // step 1's blocks a chunk
  constexpr int state_smem = StateSmem<P, state_cols<N>()>::BYTES;
  constexpr int scan_smem = ScanSmem<P, N>::BYTES;
  auto state = ssd_chunk_state<P, N>;
  auto scan = ssd_chunk_scan<P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      state, cudaFuncAttributeMaxDynamicSharedMemorySize, state_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_smem);
  if (err != cudaSuccess) return err;

  state<<<dim3(nc * split, H, B), WG, state_smem, stream>>>(
      xh, static_cast<const float*>(dt), static_cast<const float*>(A), Bh,
      states, cum_ws, dt_ws, S, H, G, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long total = long(B) * H * P * N / 4;
  auto pass = ssd_state_pass<P, N>;
  pass<<<unsigned((total + 255) / 256), 256, 0, stream>>>(
      states, cum_ws, static_cast<const float*>(init), prev,
      static_cast<float*>(final_state), H, Q, nc, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan<<<dim3(nc, H, n_tiles * B), WG, scan_smem, stream>>>(
      xh, Bh, static_cast<const bf16*>(Cm), prev, cum_ws, dt_ws,
      static_cast<bf16*>(y), S, H, G, Q);
  return cudaGetLastError();
}

// ------------------------------------------------------ fp32: CUDA cores

constexpr int TY = 16;            // thread grid: TY x TX = 256 threads
constexpr int TX = 16;
constexpr int THREADS = TY * TX;
constexpr int RQ = TILE / TY;     // score rows per thread
constexpr int CK = TILE / TX;     // score columns per thread
constexpr int WS = TILE + 4;      // W row stride: the two row groups of a
                                  // warp land 16 banks apart

template <int PW, int N>
size_t simt_smem_bytes(int Q) {
  const int Qp = round_up(Q, TILE);
  return sizeof(float) *
         (size_t(Qp) * 2 + size_t(Qp) * PW + size_t(PW) * (N + 1) +
          size_t(TILE) * (N + 1) * 2 + size_t(TILE) * WS);
}

// Stage rows [r0, r0 + TILE) of a chunk of B or C (row stride G * N) into a
// [TILE][N + 1] tile, zero where the row is past the chunk or S.
template <int N>
__device__ void load_tile(float* dst, const float* src, int r0,
                          int chunk_rows, long row_stride) {
  constexpr int NP = N + 1;
  for (int e = threadIdx.x; e < TILE * N; e += THREADS) {
    const int r = e / N, n = e % N, rr = r0 + r;
    dst[r * NP + n] = rr < chunk_rows ? src[rr * row_stride + n] : 0.f;
  }
}

// The first port's kernel, for fp32: one block per (P-slice of PW <= 32
// channels, head, batch), walking the chunks in order with the [PW, N] fp32
// state in shared memory; rows in 64 x 64 tiles (C B^T, the decay mask,
// then the product with dt x), fp32 FMAs throughout.  y[:, p] and
// state[p, :] depend only on x[:, p], so the split over P is exact.
template <int PW, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_simt(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ init,
              float* __restrict__ y, float* __restrict__ final_state, int S,
              int H, int G, int P, int Q) {
  constexpr int NP = N + 1;
  constexpr int AD = PW / TX;     // y columns per thread
  const int Qp = round_up(Q, TILE);
  extern __shared__ float smem_f[];
  float* cum = smem_f;            // [Qp] running sum of dt * A in the chunk
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
  const float* xb = x + (long(b) * S * H + h) * P + p0;
  float* yb = y + (long(b) * S * H + h) * P + p0;
  const float* dtb = dt + long(b) * S * H + h;
  const float* Bb = Bm + (long(b) * S * G + g) * N;
  const float* Cb = Cm + (long(b) * S * G + g) * N;
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
    if (tid < 32) warp_scan(cum, Qp, tid);
    for (int e = tid; e < Qp * PW; e += THREADS) {
      const int r = e / PW, p = e % PW;
      xdt[e] = r < rows ? xb[long(t0 + r) * x_row + p] * wts[r] : 0.f;
    }
    __syncthreads();

    const float* Bc = Bb + long(t0) * bc_row;
    const float* Cc = Cb + long(t0) * bc_row;
    for (int i0 = 0; i0 < rows; i0 += TILE) {
      __syncthreads();                  // the previous tile's readers
      load_tile<N>(Cs, Cc, i0, rows, bc_row);
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
        load_tile<N>(Bs, Bc, j0, rows, bc_row);
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
        float* yr = yb + long(t0 + r) * x_row;
#pragma unroll
        for (int a = 0; a < AD; ++a) yr[tx + a * TX] = acc[i][a];
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
      load_tile<N>(Bs, Bc, j0, rows, bc_row);
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

template <int PW, int N>
cudaError_t launch_simt(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* init,
                        void* y, void* final_state, int B, int S, int H,
                        int G, int P, int Q, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes<PW, N>(Q);
  auto kernel = ssd_scan_simt<PW, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(P / PW, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(final_state), S, H, G, P,
      Q);
  return cudaGetLastError();
}

// ------------------------------------------------------------ dispatching

bool valid_dims(int B, int S, int H, int G, int Q) {
  return B > 0 && S > 0 && G > 0 && H % G == 0 && Q >= 1 && Q <= MAX_Q;
}

}  // namespace

// bf16 x/B/C: the three tensor-core launches (steps 1-3 above).
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* init,
                             void* y, void* final_state, void* ws, int B,
                             int S, int H, int G, int P, int N, int Q,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_dims(B, S, H, G, Q) || ws == nullptr)
    return int(cudaErrorInvalidValue);
  return int(by_width(P, [&](auto p) {
    return by_width(N, [&](auto n) {
      return launch_wgmma<decltype(p)::value, decltype(n)::value>(
          x, dt, A, Bm, Cm, init, y, final_state, ws, B, S, H, G, Q, st);
    });
  }));
}

// fp32 x/B/C: the CUDA-core kernel, ssd_scan_simt (no workspace); P = 16
// takes slices of 16 channels, the wider heads slices of 32.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* init,
                            void* y, void* final_state, void* /*ws*/, int B,
                            int S, int H, int G, int P, int N, int Q,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_dims(B, S, H, G, Q)) return int(cudaErrorInvalidValue);
  return int(by_width(P, [&](auto p) {
    return by_width(N, [&](auto n) {
      constexpr int PW = decltype(p)::value == 16 ? 16 : 32;
      return launch_simt<PW, decltype(n)::value>(
          x, dt, A, Bm, Cm, init, y, final_state, B, S, H, G, P, Q, st);
    });
  }));
}

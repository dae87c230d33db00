// Legendre-stage kernels of the spherical harmonic transforms, for Hopper.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math); bound through the plain C
//        interface at the end of this file (ctypes, repro_torch.kernels.build).
//
// Every kernel runs the scaled float32 recurrence of the reference's
// `_f32_step` (src/repro/kernels/legendre_pallas.py:76): P_{l,m} is carried as
// a (mantissa, scale) pair, P = mant * 2^(64 scale), renormalised by 2^+-64
// with selects, and a value counts only where scale == 0.  The seeds pmm
// (f32) / pms (i32) come precomputed from the host in float64.  Rows with
// m < 0 are plan padding and write exact zeros.  Channels are 2K (re | im).
//
// beta_{l,m} and beta_{l,m}/beta_{l-1,m} depend on (l, m) only, not on the
// ring, so each block computes them once per l-tile into shared memory with
// the reference's float32 formula, instead of every thread recomputing them:
// no table reaches device memory, as in the paper's on-the-fly choice, and
// the per-ring step is a handful of multiplies.
//
// The recurrence amplifies a last-bit difference anywhere in it to about
// 4e-4 of max|Delta| by l_max 256, so the kernel rounds exactly as its plain
// PyTorch version does: every operation of the recurrence is a separately
// rounded IEEE one (no contraction), and 1/sqrt is a correctly rounded
// square root and division rather than the approximate rsqrt.  Only the
// accumulation (fmaf, summation order) differs from the plain version.  The
// recurrence step lives in recurrence.cuh, shared with fused.cu.
//
// Every kernel also has its spin branch (template SPIN = true, selected by a
// non-null mp_vals): the Wigner-d rows (m, m') of the spin-2 transforms, run
// by the reference's `_f32_step_spin` (legendre_pallas.py:116).  A row then
// starts at l0 = max(m, |m'|) instead of m, the per-tile table holds the
// a, b, c coefficients instead of beta and its ratio, and anal_reduce zeroes
// l < l0.  The spin-2 plans never fold, so SPIN comes with FOLD = false only.
//
// Kernels (TPU kernel each replaces; what bounds it on the H100; design):
//
//   synth_vpu   replaces synth_vpu, src/repro/kernels/legendre_pallas.py:222.
//               float32 operations bound (paper Alg. 4): one thread per ring,
//               one block per (128-ring tile, m, channel chunk of <= 16); the
//               l loop runs inside the thread from l = m, the warp-uniform
//               a_lm rows of each 32-l tile are staged through shared memory
//               and the accumulators stay in registers.  Larger 2K runs more
//               channel chunks, each recomputing the recurrence.
//   synth_mxu   replaces synth_mxu, legendre_pallas.py:326.  float32
//               operations bound: per (m, 128-ring tile) the block builds a
//               (32 l x 128 ring) P panel in shared memory, then contracts it
//               against the (32 l x CC) coefficient panel with a register-tiled
//               product in full float32 on the CUDA cores (no TF32, no wgmma:
//               same error band as synth_vpu).
//   anal_vpu    replaces anal_vpu, legendre_pallas.py:436 (paper Alg. 5).
//               float32 operations bound; the ring reduction is the hard
//               part.  One block per (m, 1024-ring chunk, channel chunk of
//               <= 4); each thread carries the recurrence of 8 rings (one per
//               128-ring tile of the chunk, in registers), sums its rings'
//               products per l, then a fixed xor-butterfly warp reduction and
//               a fixed-order sum over the block's 4 warps give the chunk's
//               partial row.  No atomics.
//   anal_mxu    replaces anal_mxu, legendre_pallas.py:1042.  float32
//               operations bound: one block per (m, 512-ring chunk, channel
//               chunk of <= 16) with the chunk's weighted Delta resident in
//               shared memory; per 32-l panel it builds the P panel of each of
//               the chunk's 4 ring tiles in turn and contracts it (register
//               tiles, ring range split over thread groups), then sums the
//               groups in a fixed order into the chunk's partial rows.
//   anal_reduce replaces the cross-ring-block accumulation the TPU kernels
//               do in sequential grid order (legendre_pallas.py:430 and
//               :1035), which has no counterpart across CUDA blocks.  Bytes
//               bound: one thread per output (m, l, channel) sums the ring
//               chunks' partials in chunk order, so repeated runs give
//               identical bits.

#include "recurrence.cuh"

namespace {

// ---------------------------------------------------------------------------
// synth_vpu: Delta_m(r) = sum_l a_lm P_lm(x_r), one ring per thread.
// grid (ceil(R / 128), Mp, ceil(K2 / KC)), block 128.
// ---------------------------------------------------------------------------
template <int KC, bool FOLD, bool SPIN>
__global__ void __launch_bounds__(kTile)
synth_vpu_kernel(const float* __restrict__ a, const int* __restrict__ m_vals,
                 const int* __restrict__ mp_vals, const float* __restrict__ x,
                 const float* __restrict__ pmm, const int* __restrict__ pms,
                 float* __restrict__ out, int L1, int K2, int R, int l_end) {
  constexpr int P = FOLD ? 2 : 1;
  __shared__ __align__(16) float a_s[kLT][KC];
  __shared__ float bl_s[kLT], ratio_s[kLT], c_s[SPIN ? kLT : 1];
  const int mi = blockIdx.y;
  const int r = blockIdx.x * kTile + threadIdx.x;
  const int c0 = blockIdx.z * KC;
  const int nch = min(KC, K2 - c0);
  const int m = m_vals[mi];
  const int mp = SPIN ? mp_vals[mi] : 0;
  const int lz = row_start<SPIN>(m, mp);
  const bool live = r < R;
  float acc[P][KC];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[p][c] = 0.0f;

  if (m >= 0) {   // block-uniform
    const size_t row = static_cast<size_t>(mi) * R + r;
    const float xr = live ? x[r] : 0.0f;
    const float pmm_r = live ? pmm[row] : 0.0f;
    const int pms_r = live ? pms[row] : 0;
    const float p1 = p_first_coef(m);
    Rec s;
    for (int l0 = lz; l0 < l_end; l0 += kLT) {
      const int n = min(kLT, l_end - l0);
      __syncthreads();                       // previous tile consumed
      for (int i = threadIdx.x; i < kLT * KC; i += kTile) {
        const int j = i / KC, c = i % KC;
        a_s[j][c] = (j < n && c < nch)
            ? a[(static_cast<size_t>(mi) * L1 + l0 + j) * K2 + c0 + c]
            : 0.0f;
      }
      fill_coef<SPIN>(l0, m, mp, bl_s, ratio_s, c_s);
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const int l = l0 + j;
        const float v = rec_step<SPIN>(&s, l, lz, xr, bl_s, ratio_s, c_s, j,
                                       p1, pmm_r, pms_r);
        if (FOLD && ((l + m) & 1)) {
#pragma unroll
          for (int c = 0; c < KC; ++c)
            acc[P - 1][c] = fmaf(v, a_s[j][c], acc[P - 1][c]);
        } else {
#pragma unroll
          for (int c = 0; c < KC; ++c)
            acc[0][c] = fmaf(v, a_s[j][c], acc[0][c]);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < nch)
          out[((static_cast<size_t>(mi) * P + p) * R + r) * K2 + c0 + c] =
              acc[p][c];
  }
}

// ---------------------------------------------------------------------------
// synth_mxu: per (m, 128-ring tile) a (32 x 128) P panel in shared memory,
// contracted against the (32 x CC) coefficient panel.  Thread t owns TR
// consecutive rings x TC channels of the (128 x CC) output tile.
// grid (ceil(R / 128), Mp, ceil(K2 / CC)), block 128.
// ---------------------------------------------------------------------------
template <int CC, bool FOLD, bool SPIN>
__global__ void __launch_bounds__(kTile)
synth_mxu_kernel(const float* __restrict__ a, const int* __restrict__ m_vals,
                 const int* __restrict__ mp_vals, const float* __restrict__ x,
                 const float* __restrict__ pmm, const int* __restrict__ pms,
                 float* __restrict__ out, int L1, int K2, int R, int l_end) {
  constexpr int P = FOLD ? 2 : 1;
  constexpr int TC = CC < 4 ? CC : 4;     // channels per thread
  constexpr int CG = CC / TC;             // channel groups
  constexpr int TR = CG;                  // rings per thread (128 / (128/CG))
  __shared__ __align__(16) float panel_s[kLT][kTile];
  __shared__ __align__(16) float coef_s[kLT][CC];
  __shared__ float bl_s[kLT], ratio_s[kLT], c_s[SPIN ? kLT : 1];
  const int mi = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const int c0 = blockIdx.z * CC;
  const int nch = min(CC, K2 - c0);
  const int m = m_vals[mi];
  const int mp = SPIN ? mp_vals[mi] : 0;
  const int lz = row_start<SPIN>(m, mp);
  const int t = threadIdx.x;
  const int cg = t % CG, rg = t / CG;
  float acc[P][TR][TC];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int k = 0; k < TC; ++k) acc[p][i][k] = 0.0f;

  if (m >= 0) {   // block-uniform
    const int r = tile0 + t;
    const bool live = r < R;
    const size_t row = static_cast<size_t>(mi) * R + r;
    const float xr = live ? x[r] : 0.0f;
    const float pmm_r = live ? pmm[row] : 0.0f;
    const int pms_r = live ? pms[row] : 0;
    const float p1 = p_first_coef(m);
    Rec s;
    for (int l0 = lz; l0 < l_end; l0 += kLT) {
      const int n = min(kLT, l_end - l0);
      __syncthreads();                       // previous panel consumed
      fill_coef<SPIN>(l0, m, mp, bl_s, ratio_s, c_s);
      for (int i = t; i < kLT * CC; i += kTile) {
        const int j = i / CC, c = i % CC;
        coef_s[j][c] = (j < n && c < nch)
            ? a[(static_cast<size_t>(mi) * L1 + l0 + j) * K2 + c0 + c]
            : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < n; ++j)             // build the P panel
        panel_s[j][t] = rec_step<SPIN>(&s, l0 + j, lz, xr, bl_s, ratio_s,
                                       c_s, j, p1, pmm_r, pms_r);
      __syncthreads();
      for (int j = 0; j < n; ++j) {           // contract over l
        float pv[TR], cv[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) pv[i] = panel_s[j][rg * TR + i];
#pragma unroll
        for (int k = 0; k < TC; ++k) cv[k] = coef_s[j][cg * TC + k];
        const int p = (FOLD && ((l0 + j + m) & 1)) ? P - 1 : 0;
        if (p) {
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int k = 0; k < TC; ++k)
              acc[P - 1][i][k] = fmaf(pv[i], cv[k], acc[P - 1][i][k]);
        } else {
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int k = 0; k < TC; ++k)
              acc[0][i][k] = fmaf(pv[i], cv[k], acc[0][i][k]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = tile0 + rg * TR + i;
    if (r >= R) continue;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int k = 0; k < TC; ++k) {
        const int c = cg * TC + k;
        if (c < nch)
          out[((static_cast<size_t>(mi) * P + p) * R + r) * K2 + c0 + c] =
              acc[p][i][k];
      }
  }
}

// ---------------------------------------------------------------------------
// anal_vpu partials: part[m][chunk][l][c] = sum over the chunk's rings of
// dw_m(r) P_lm(r).  Thread t carries rings chunk0 + k * 128 + t, k < 8.
// grid (n_chunks, Mp, ceil(K2 / KC)), block 128.
// ---------------------------------------------------------------------------
template <int KC, bool FOLD, bool SPIN>
__global__ void __launch_bounds__(kTile)
anal_vpu_kernel(const float* __restrict__ dw, const int* __restrict__ m_vals,
                const int* __restrict__ mp_vals, const float* __restrict__ x,
                const float* __restrict__ pmm, const int* __restrict__ pms,
                float* __restrict__ part, int K2, int R, int l_end) {
  constexpr int P = FOLD ? 2 : 1;
  constexpr int kWarps = kTile / 32;
  __shared__ float row_s[kWarps][kLT][KC];
  __shared__ float bl_s[kLT], ratio_s[kLT], c_s[SPIN ? kLT : 1];
  const int mi = blockIdx.y;
  const int chunk = blockIdx.x;
  const int base = chunk * kVpuAnalTiles * kTile;
  const int c0 = blockIdx.z * KC;
  const int nch = min(KC, K2 - c0);
  const int m = m_vals[mi];
  if (m < 0) return;                         // block-uniform; reduce zeroes it
  const int mp = SPIN ? mp_vals[mi] : 0;
  const int lz = row_start<SPIN>(m, mp);     // reduce zeroes the rows below
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ntile = min(kVpuAnalTiles, (R - base + kTile - 1) / kTile);
  const float p1 = p_first_coef(m);

  Rec s[kVpuAnalTiles];
  float xr[kVpuAnalTiles], pmm_r[kVpuAnalTiles];
  int pms_r[kVpuAnalTiles];
  float d[kVpuAnalTiles][P][KC];
#pragma unroll
  for (int k = 0; k < kVpuAnalTiles; ++k) {
    const int r = base + k * kTile + t;
    const bool live = k < ntile && r < R;
    const size_t row = static_cast<size_t>(mi) * R + r;
    xr[k] = live ? x[r] : 0.0f;
    pmm_r[k] = live ? pmm[row] : 0.0f;
    pms_r[k] = live ? pms[row] : 0;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < KC; ++c)
        d[k][p][c] = (live && c < nch)
            ? dw[((static_cast<size_t>(mi) * P + p) * R + r) * K2 + c0 + c]
            : 0.0f;
  }

  for (int l0 = lz; l0 < l_end; l0 += kLT) {
    const int n = min(kLT, l_end - l0);
    fill_coef<SPIN>(l0, m, mp, bl_s, ratio_s, c_s);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int l = l0 + j;
      const int p = (FOLD && ((l + m) & 1)) ? P - 1 : 0;
      float sum[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) sum[c] = 0.0f;
#pragma unroll
      for (int k = 0; k < kVpuAnalTiles; ++k) {
        if (k < ntile) {                      // block-uniform
          const float v = rec_step<SPIN>(&s[k], l, lz, xr[k], bl_s, ratio_s,
                                         c_s, j, p1, pmm_r[k], pms_r[k]);
          if (p) {
#pragma unroll
            for (int c = 0; c < KC; ++c)
              sum[c] = fmaf(v, d[k][P - 1][c], sum[c]);
          } else {
#pragma unroll
            for (int c = 0; c < KC; ++c) sum[c] = fmaf(v, d[k][0][c], sum[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) row_s[warp][j][c] = sum[c];
      }
    }
    __syncthreads();
    for (int i = t; i < n * KC; i += kTile) {
      const int j = i / KC, c = i % KC;
      if (c < nch) {
        float total = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += row_s[w][j][c];
        part[((static_cast<size_t>(mi) * gridDim.x + chunk) * l_end + l0 + j) *
                 K2 + c0 + c] = total;
      }
    }
    __syncthreads();                         // row_s / beta reused next tile
  }
}

// ---------------------------------------------------------------------------
// anal_mxu partials: per 32-l panel, for each of the chunk's 4 ring tiles,
// build the (32 x 128) P panel and contract it against the tile's resident
// weighted Delta.  Thread t = q * (8 * CG) + jg * CG + cg owns output rows
// jg*4 .. jg*4+3, channels cg*TC .. +TC, over ring split q of each tile.
// grid (n_chunks, Mp, ceil(K2 / CC)), block 128, dynamic shared memory.
// ---------------------------------------------------------------------------
template <int CC, bool FOLD, bool SPIN>
struct AnalMxuShape {
  static constexpr int P = FOLD ? 2 : 1;
  static constexpr int TC = CC < 4 ? CC : 4;
  static constexpr int CG = CC / TC;
  static constexpr int TJ = 4;                     // rows per thread
  static constexpr int JG = kLT / TJ;              // row groups (8)
  static constexpr int Q = kTile / (JG * CG);      // ring splits
  static constexpr int RS = kTile / Q;             // rings per split
  static constexpr int kChunk = kMxuAnalTiles * kTile;
  static constexpr int kPanelStride = kTile + 1;   // conflict-free columns
  static constexpr size_t dw_floats = static_cast<size_t>(P) * kChunk * CC;
  static constexpr size_t panel_floats = static_cast<size_t>(kLT) * kPanelStride;
  static constexpr size_t red_floats = static_cast<size_t>(Q) * kLT * CC;
  static constexpr size_t coef_floats = static_cast<size_t>(SPIN ? 3 : 2) * kLT;
  static constexpr size_t smem_bytes =
      (dw_floats + panel_floats + red_floats + coef_floats) * sizeof(float);
};

template <int CC, bool FOLD, bool SPIN>
__global__ void __launch_bounds__(kTile)
anal_mxu_kernel(const float* __restrict__ dw, const int* __restrict__ m_vals,
                const int* __restrict__ mp_vals, const float* __restrict__ x,
                const float* __restrict__ pmm, const int* __restrict__ pms,
                float* __restrict__ part, int K2, int R, int l_end) {
  using S = AnalMxuShape<CC, FOLD, SPIN>;
  constexpr int P = S::P, TC = S::TC, CG = S::CG, TJ = S::TJ, Q = S::Q,
                RS = S::RS;
  extern __shared__ __align__(16) float smem[];
  float* dw_s = smem;                                  // [P][kChunk][CC]
  float* panel_s = dw_s + S::dw_floats;                // [kLT][kPanelStride]
  float* red_s = panel_s + S::panel_floats;            // [Q][kLT][CC]
  float* bl_s = red_s + S::red_floats;                 // [kLT]
  float* ratio_s = bl_s + kLT;                         // [kLT]
  float* c_s = ratio_s + kLT;                          // [kLT] (SPIN only)

  const int mi = blockIdx.y;
  const int chunk = blockIdx.x;
  const int base = chunk * S::kChunk;
  const int c0 = blockIdx.z * CC;
  const int nch = min(CC, K2 - c0);
  const int m = m_vals[mi];
  if (m < 0) return;                         // block-uniform; reduce zeroes it
  const int mp = SPIN ? mp_vals[mi] : 0;
  const int lz = row_start<SPIN>(m, mp);     // reduce zeroes the rows below
  const int t = threadIdx.x;
  const int cg = t % CG, jg = (t / CG) % S::JG, q = t / (CG * S::JG);
  const int ntile = min(kMxuAnalTiles, (R - base + kTile - 1) / kTile);
  const float p1 = p_first_coef(m);

  for (int i = t; i < P * S::kChunk * CC; i += kTile) {
    const int c = i % CC, rr = (i / CC) % S::kChunk, p = i / (CC * S::kChunk);
    const int r = base + rr;
    dw_s[i] = (r < R && c < nch)
        ? dw[((static_cast<size_t>(mi) * P + p) * R + r) * K2 + c0 + c]
        : 0.0f;
  }
  Rec s[kMxuAnalTiles];
  float xr[kMxuAnalTiles], pmm_r[kMxuAnalTiles];
  int pms_r[kMxuAnalTiles];
#pragma unroll
  for (int k = 0; k < kMxuAnalTiles; ++k) {
    const int r = base + k * kTile + t;
    const bool live = k < ntile && r < R;
    const size_t row = static_cast<size_t>(mi) * R + r;
    xr[k] = live ? x[r] : 0.0f;
    pmm_r[k] = live ? pmm[row] : 0.0f;
    pms_r[k] = live ? pms[row] : 0;
  }

  for (int l0 = lz; l0 < l_end; l0 += kLT) {
    const int n = min(kLT, l_end - l0);
    fill_coef<SPIN>(l0, m, mp, bl_s, ratio_s, c_s);
    __syncthreads();
    const int pb = FOLD ? ((l0 + m) & 1) : 0;     // plane of even rows
    float acc[TJ][TC];
#pragma unroll
    for (int i = 0; i < TJ; ++i)
#pragma unroll
      for (int k = 0; k < TC; ++k) acc[i][k] = 0.0f;
#pragma unroll
    for (int k = 0; k < kMxuAnalTiles; ++k) {
      if (k >= ntile) break;                  // block-uniform
      for (int j = 0; j < kLT; ++j)           // build the P panel
        panel_s[j * S::kPanelStride + t] =
            j < n ? rec_step<SPIN>(&s[k], l0 + j, lz, xr[k], bl_s, ratio_s,
                                   c_s, j, p1, pmm_r[k], pms_r[k])
                  : 0.0f;
      __syncthreads();
      const float* d0 = dw_s + (static_cast<size_t>(pb) * S::kChunk +
                                k * kTile) * CC;
      const float* d1 = dw_s + (static_cast<size_t>(FOLD ? 1 - pb : 0) *
                                S::kChunk + k * kTile) * CC;
      for (int rr = 0; rr < RS; ++rr) {       // contract over rings
        const int ring = q * RS + rr;
        float pv[TJ], e0[TC], e1[TC];
#pragma unroll
        for (int i = 0; i < TJ; ++i)
          pv[i] = panel_s[(jg * TJ + i) * S::kPanelStride + ring];
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          e0[c] = d0[ring * CC + cg * TC + c];
          e1[c] = FOLD ? d1[ring * CC + cg * TC + c] : e0[c];
        }
#pragma unroll
        for (int i = 0; i < TJ; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c)
            acc[i][c] = fmaf(pv[i], (i & 1) ? e1[c] : e0[c], acc[i][c]);
      }
      __syncthreads();                        // panel reused by next tile
    }
#pragma unroll
    for (int i = 0; i < TJ; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c)
        red_s[(q * kLT + jg * TJ + i) * CC + cg * TC + c] = acc[i][c];
    __syncthreads();
    for (int i = t; i < n * CC; i += kTile) {
      const int j = i / CC, c = i % CC;
      if (c < nch) {
        float total = 0.0f;
#pragma unroll
        for (int qq = 0; qq < Q; ++qq) total += red_s[(qq * kLT + j) * CC + c];
        part[((static_cast<size_t>(mi) * gridDim.x + chunk) * l_end + l0 + j) *
                 K2 + c0 + c] = total;
      }
    }
    __syncthreads();                         // red_s / beta reused next panel
  }
}

// ---------------------------------------------------------------------------
// anal_reduce: out[m][l][c] = sum over chunks, in chunk order, of
// part[m][chunk][l][c]; zero where l < m (l < max(m, |m'|) with mp_vals)
// or m < 0.
// ---------------------------------------------------------------------------
__global__ void anal_reduce_kernel(const float* __restrict__ part,
                                   const int* __restrict__ m_vals,
                                   const int* __restrict__ mp_vals,
                                   float* __restrict__ out, int Mp,
                                   int n_chunks, int L, int K2) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(Mp) * L * K2;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % K2);
  const int l = static_cast<int>((idx / K2) % L);
  const int mi = static_cast<int>(idx / (static_cast<size_t>(K2) * L));
  const int m = m_vals[mi];
  const int lz = mp_vals != nullptr ? max(m, abs(mp_vals[mi])) : m;
  float sum = 0.0f;
  if (m >= 0 && l >= lz) {
    for (int ch = 0; ch < n_chunks; ++ch)
      sum += part[((static_cast<size_t>(mi) * n_chunks + ch) * L + l) * K2 + c];
  }
  out[idx] = sum;
}

// ---------------------------------------------------------------------------
// launch helpers: pick the channel-chunk template for K2, the fold, and
// the spin branch (spin with fold off only).
// ---------------------------------------------------------------------------
template <template <int, bool, bool> class Launch, int KC, typename Args>
int dispatch_flags(int fold, bool spin, const Args& g) {
  if (spin)
    return fold ? static_cast<int>(cudaErrorInvalidValue)
                : Launch<KC, false, true>::run(g);
  return fold ? Launch<KC, true, false>::run(g)
              : Launch<KC, false, false>::run(g);
}

template <template <int, bool, bool> class Launch, typename Args>
int dispatch(int kc, int fold, bool spin, const Args& g) {
  switch (kc) {
    case 2: return dispatch_flags<Launch, 2>(fold, spin, g);
    case 4: return dispatch_flags<Launch, 4>(fold, spin, g);
    case 8: return dispatch_flags<Launch, 8>(fold, spin, g);
    case 16: return dispatch_flags<Launch, 16>(fold, spin, g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct SynthArgs {
  const float* a; const int* m_vals; const int* mp_vals; const float* x;
  const float* pmm; const int* pms; float* out; int Mp; int L1; int K2;
  int R; int l_end; cudaStream_t stream;
};

struct AnalArgs {
  const float* dw; const int* m_vals; const int* mp_vals; const float* x;
  const float* pmm; const int* pms; float* part; int Mp; int K2; int R;
  int l_end; int n_chunks; cudaStream_t stream;
};

template <int KC, bool FOLD, bool SPIN>
struct LaunchSynthVpu {
  static int run(const SynthArgs& g) {
    dim3 grid((g.R + kTile - 1) / kTile, g.Mp, (g.K2 + KC - 1) / KC);
    synth_vpu_kernel<KC, FOLD, SPIN><<<grid, kTile, 0, g.stream>>>(
        g.a, g.m_vals, g.mp_vals, g.x, g.pmm, g.pms, g.out, g.L1, g.K2, g.R,
        g.l_end);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int CC, bool FOLD, bool SPIN>
struct LaunchSynthMxu {
  static int run(const SynthArgs& g) {
    dim3 grid((g.R + kTile - 1) / kTile, g.Mp, (g.K2 + CC - 1) / CC);
    synth_mxu_kernel<CC, FOLD, SPIN><<<grid, kTile, 0, g.stream>>>(
        g.a, g.m_vals, g.mp_vals, g.x, g.pmm, g.pms, g.out, g.L1, g.K2, g.R,
        g.l_end);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int KC, bool FOLD, bool SPIN>
struct LaunchAnalVpu {
  static int run(const AnalArgs& g) {
    dim3 grid(g.n_chunks, g.Mp, (g.K2 + KC - 1) / KC);
    anal_vpu_kernel<KC, FOLD, SPIN><<<grid, kTile, 0, g.stream>>>(
        g.dw, g.m_vals, g.mp_vals, g.x, g.pmm, g.pms, g.part, g.K2, g.R,
        g.l_end);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int CC, bool FOLD, bool SPIN>
struct LaunchAnalMxu {
  static int run(const AnalArgs& g) {
    using S = AnalMxuShape<CC, FOLD, SPIN>;
    cudaError_t err = cudaFuncSetAttribute(
        anal_mxu_kernel<CC, FOLD, SPIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(g.n_chunks, g.Mp, (g.K2 + CC - 1) / CC);
    anal_mxu_kernel<CC, FOLD, SPIN><<<grid, kTile, S::smem_bytes, g.stream>>>(
        g.dw, g.m_vals, g.mp_vals, g.x, g.pmm, g.pms, g.part, g.K2, g.R,
        g.l_end);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface.  Pointers are device pointers of contiguous tensors;
// mp_vals (m' per row) may be null: the scalar rows, else the spin branch.
// Every function launches on `stream` and returns cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" {

int legendre_synth_vpu(const float* a, const int* m_vals, const int* mp_vals,
                       const float* x, const float* pmm, const int* pms,
                       float* out, int Mp, int L1, int K2, int R, int l_end,
                       int fold, void* stream) {
  SynthArgs g{a, m_vals, mp_vals, x, pmm, pms, out, Mp, L1, K2, R, l_end,
              static_cast<cudaStream_t>(stream)};
  return dispatch<LaunchSynthVpu>(chunk_for(K2, 16), fold, mp_vals != nullptr,
                                  g);
}

int legendre_synth_mxu(const float* a, const int* m_vals, const int* mp_vals,
                       const float* x, const float* pmm, const int* pms,
                       float* out, int Mp, int L1, int K2, int R, int l_end,
                       int fold, void* stream) {
  SynthArgs g{a, m_vals, mp_vals, x, pmm, pms, out, Mp, L1, K2, R, l_end,
              static_cast<cudaStream_t>(stream)};
  return dispatch<LaunchSynthMxu>(chunk_for(K2, 16), fold, mp_vals != nullptr,
                                  g);
}

int legendre_anal_vpu(const float* dw, const int* m_vals, const int* mp_vals,
                      const float* x, const float* pmm, const int* pms,
                      float* part, int Mp, int K2, int R, int l_end,
                      int n_chunks, int fold, void* stream) {
  if (n_chunks != chunks_of(R, kVpuAnalTiles))
    return static_cast<int>(cudaErrorInvalidValue);
  AnalArgs g{dw, m_vals, mp_vals, x, pmm, pms, part, Mp, K2, R, l_end,
             n_chunks, static_cast<cudaStream_t>(stream)};
  return dispatch<LaunchAnalVpu>(chunk_for(K2, 4), fold, mp_vals != nullptr,
                                 g);
}

int legendre_anal_mxu(const float* dw, const int* m_vals, const int* mp_vals,
                      const float* x, const float* pmm, const int* pms,
                      float* part, int Mp, int K2, int R, int l_end,
                      int n_chunks, int fold, void* stream) {
  if (n_chunks != chunks_of(R, kMxuAnalTiles))
    return static_cast<int>(cudaErrorInvalidValue);
  AnalArgs g{dw, m_vals, mp_vals, x, pmm, pms, part, Mp, K2, R, l_end,
             n_chunks, static_cast<cudaStream_t>(stream)};
  return dispatch<LaunchAnalMxu>(chunk_for(K2, 16), fold, mp_vals != nullptr,
                                 g);
}

int legendre_anal_reduce(const float* part, const int* m_vals,
                         const int* mp_vals, float* out, int Mp, int n_chunks,
                         int L, int K2, void* stream) {
  const size_t total = static_cast<size_t>(Mp) * L * K2;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  anal_reduce_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      part, m_vals, mp_vals, out, Mp, n_chunks, L, K2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// rounded IEEE one (no contraction, but for the two fused multiply-adds of
// the spin update, recurrence.cuh), and 1/sqrt is a correctly rounded
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
//               Bound by instruction issue, as synth_fused_vpu (fused.cu),
//               whose template it shares (recurrence.cuh): the bit-faithful
//               step issues ~22 SASS instructions a triple at K 1 against
//               the 6 float32 instructions (8 operations) of the flop bound.
//               One block per (128 RT-ring block, m, channel chunk of
//               <= 16); each thread carries RT = synth_rings(KC / 2) rings
//               (4 at KC 2 and 4, 2 at 8, 1 at 16: <= 32 accumulators),
//               base + k * 128 + t, so the writes stay coalesced.  Per
//               32-l tile the block stages the a rows and the recurrence
//               table in shared memory; the seed and P_{m+1,m} are peeled
//               off the l loop, full ring blocks run unguarded and the
//               fold's planes are a two-step unroll, so the steady step
//               has no branch and loads its a row once for all RT rings.
//               Each ring's sum is one fmaf chain over ascending l from
//               0.0f, the bits of one ring a thread.
//   synth_mxu   replaces synth_mxu, legendre_pallas.py:326.  Bound by
//               instruction issue, as synth_fused_mxu (fused.cu), whose
//               template it shares (mxu_synth.cuh): the bit-faithful step
//               (~20 SASS instructions a triple) and the 2K FFMA of each
//               triple issue far more than the float32 operations of the
//               flop bound.  One block of 256 threads per (m, 512-ring
//               chunk, channel chunk of <= 16); each thread steps a ring
//               pair (seed and P_{m+1,m} peeled off, no guard, one table
//               entry an l for both) and adds each value times the l's
//               coefficients (broadcast float4 loads of rows staged 256 l
//               at a time) into its registers, the fold's planes a two-step
//               unroll: no panel, two barriers per 256 l, three blocks (24
//               warps) an SM without the fold.  Full float32 on the CUDA
//               cores (no TF32, no wgmma); each output is one fmaf chain
//               over ascending l from 0.0f, the bits of one ring a thread.
//   anal_vpu    replaces anal_vpu, legendre_pallas.py:436 (paper Alg. 5).
//               Bound by instruction issue, as anal_fused_vpu (fused.cu),
//               whose template it shares (recurrence.cuh): the bit-faithful
//               step issues ~22 SASS instructions a triple at K 1 against
//               the 6 float32 instructions (8 operations) of the flop bound.
//               One block per (m, 1024-ring chunk, channel chunk of <= 4);
//               each thread carries the recurrence of 8 rings in registers,
//               the seed and P_{m+1,m} peeled off the l loop, full chunks
//               unguarded and the fold's planes a two-step unroll, so the
//               steady step has no branch and loads its coefficients once
//               for all 8 rings.  Per l each thread stores its rings' sum
//               per channel into its shared-memory column; per 32-l tile
//               every output sums the 128 columns in one fixed order into
//               the chunk's partial row.  No atomics, no per-l shuffle
//               chain.
//   anal_mxu    replaces anal_mxu, legendre_pallas.py:1042.  Bound by
//               instruction issue and shared-memory loads, as
//               anal_fused_mxu (fused.cu), whose template it shares
//               (mxu_anal.cuh): the bit-faithful step (~22 SASS
//               instructions a triple) and the 2K FFMA of each triple issue
//               far more than the float32 operations of the flop bound.
//               One block of 256 threads per (m, 512-ring chunk, channel
//               chunk of <= 16), the chunk's weighted Delta resident in
//               shared memory, channel-major.  Per 32-l panel (16 with the
//               fold) each thread steps a ring pair (seed and P_{m+1,m}
//               peeled off, no guard, one coefficient load per l for
//               both) into the panel; one barrier; a register-tiled
//               contraction (4 l x 8 channels a thread over a ring slice,
//               one float4 of P or Delta feeding 16 or 32 FFMA); the ring
//               slices, lanes of one warp, summed by a register butterfly
//               in one fixed order straight into the chunk's partial rows;
//               one barrier.  No atomics.
//   anal_reduce replaces the cross-ring-block accumulation the TPU kernels
//               do in sequential grid order (legendre_pallas.py:430 and
//               :1035), which has no counterpart across CUDA blocks.  Bytes
//               bound (each partial read once, each output written once):
//               one block row per (m or slot) row, 32-bit indices, 16-byte
//               vectors where the row's (l, c) stretch allows (8- or 4-byte
//               otherwise), positions below l0 zeroed without reading the
//               partials, as are the slot streams' dead tails (the slot
//               layouts pass their maps); each output is the sum of the
//               ring chunks' partials in chunk order from 0.0f, so repeated
//               runs give identical bits and the same bits as a plain loop
//               of adds.

#include <cstdint>

#include "mxu_anal.cuh"
#include "mxu_synth.cuh"
#include "recurrence.cuh"

namespace {

// ---------------------------------------------------------------------------
// synth_vpu: Delta_m(r) = sum_l a_lm P_lm(x_r) through the vpu synthesis
// template (recurrence.cuh): thread t carries rings base + k * 128 + t,
// k < RT = synth_rings(KC / 2).  grid (ceil(R / (128 RT)), Mp,
// ceil(K2 / KC)), block 128.
// ---------------------------------------------------------------------------
template <int KC, bool FOLD, bool SPIN>
__global__ void __launch_bounds__(kTile)
synth_vpu_kernel(const float* __restrict__ a, const int* __restrict__ m_vals,
                 const int* __restrict__ mp_vals, const float* __restrict__ x,
                 const float* __restrict__ pmm, const int* __restrict__ pms,
                 float* __restrict__ out, int L1, int K2, int R, int l_end) {
  constexpr int P = FOLD ? 2 : 1;
  constexpr int RT = synth_rings(KC / 2);
  __shared__ __align__(16) float a_s[kLT][KC];
  __shared__ float bl_s[kLT], ratio_s[kLT], c_s[SPIN ? kLT : 1];
  const int mi = blockIdx.y;
  const int base = blockIdx.x * RT * kTile;
  const int t = threadIdx.x;
  const int c0 = blockIdx.z * KC;
  const int nch = min(KC, K2 - c0);
  const int m = m_vals[mi];
  const int mp = SPIN ? mp_vals[mi] : 0;
  const int lz = row_start<SPIN>(m, mp);
  // ring tiles with a live ring (the tail block's tiles past ntile hold
  // none, so r < R alone tells a live ring)
  const int ntile = min(RT, (R - base + kTile - 1) / kTile);
  float acc[RT][P][KC];
#pragma unroll
  for (int k = 0; k < RT; ++k)
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[k][p][c] = 0.0f;

  if (m >= 0) {   // block-uniform; a padding row writes zeros
    const size_t row = static_cast<size_t>(mi) * R;
    float xr[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int r = base + k * kTile + t;
      xr[k] = r < R ? x[r] : 0.0f;
    }
    Rec s[RT];
    for (int l0 = lz; l0 < l_end; l0 += kLT) {   // block-uniform
      const int n = min(kLT, l_end - l0);
      __syncthreads();                           // previous tile consumed
#pragma unroll
      for (int i0 = 0; i0 < kLT * KC; i0 += kTile) {  // KC / 4 entries a thread
        const int i = i0 + t, j = i / KC, c = i % KC;
        if (i < kLT * KC)
          a_s[j][c] = (j < n && c < nch)
              ? a[(static_cast<size_t>(mi) * L1 + l0 + j) * K2 + c0 + c]
              : 0.0f;
      }
      fill_coef<SPIN>(l0, m, mp, bl_s, ratio_s, c_s);
      __syncthreads();
      // the seed and (spin 0) P_{m+1,m} peeled off the first tile
      const int j = l0 == lz
          ? vpu_synth_first<RT, KC, P, SPIN>(s, xr, acc, ntile, n, m, base,
                                             R, pmm + row, pms + row, a_s)
          : 0;
      if (ntile == RT)                           // block-uniform
        vpu_synth_steps<RT, KC, P, SPIN, true>(s, xr, acc, ntile, j, n,
                                               bl_s, ratio_s, c_s, a_s);
      else
        vpu_synth_steps<RT, KC, P, SPIN, false>(s, xr, acc, ntile, j, n,
                                                bl_s, ratio_s, c_s, a_s);
    }
  }
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int r = base + k * kTile + t;
    if (r >= R) continue;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < nch)
          out[((static_cast<size_t>(mi) * P + p) * R + r) * K2 + c0 + c] =
              acc[k][p][c];
  }
}

// ---------------------------------------------------------------------------
// synth_mxu: Delta_m(r) = sum_l a_lm P_lm(x_r) through the mxu synthesis
// template (mxu_synth.cuh): thread t steps the ring pair base + 2t,
// base + 2t + 1 of the block's 512-ring chunk and sums its products over l
// in registers; the kernel hands the template the row's coefficients and
// writes both fold planes as they are.  A padding row (m < 0) runs as an
// empty row, whose sums are exact zeros.  grid (ceil(R / 512), Mp,
// ceil(K2 / CC)), block kMxuThreads, dynamic shared memory and blocks an
// SM: MxuSynthShape.
// ---------------------------------------------------------------------------
template <int CC, bool FOLD, bool SPIN>
__global__ void __launch_bounds__(
    kMxuThreads, MxuSynthShape<CC, FOLD, false>::MIN_BLOCKS)
synth_mxu_kernel(const float* __restrict__ a, const int* __restrict__ m_vals,
                 const int* __restrict__ mp_vals, const float* __restrict__ x,
                 const float* __restrict__ pmm, const int* __restrict__ pms,
                 float* __restrict__ out, int L1, int K2, int R, int l_end) {
  constexpr int P = FOLD ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  const int mi = blockIdx.y;
  const int base = blockIdx.x * kMxuChunk;
  const int c0 = blockIdx.z * CC;
  const int nch = min(CC, K2 - c0);
  const int m = m_vals[mi];
  const int mp = SPIN ? mp_vals[mi] : 0;
  const int lz = m < 0 ? l_end : row_start<SPIN>(m, mp);
  const int t = threadIdx.x;
  float xr[kMxuRings];
#pragma unroll
  for (int k = 0; k < kMxuRings; ++k) {
    const int r = base + kMxuRings * t + k;
    xr[k] = r < R ? x[r] : 0.0f;
  }
  const size_t row = static_cast<size_t>(mi) * R;
  const float* arow = a + static_cast<size_t>(mi) * L1 * K2 + c0;
  mxu_synth_row<CC, FOLD, SPIN, false>(
      smem, xr, min(kMxuChunk, R - base), m, mp, lz, l_end, pmm + row,
      pms + row, base, R,
      [&](int l, int c) {
        return c < nch ? arow[static_cast<size_t>(l) * K2 + c] : 0.0f;
      },
      [&](int rr, const float (&v)[P][CC]) {
        const int r = base + rr;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float* o = out + ((static_cast<size_t>(mi) * P + p) * R + r) * K2 +
                     c0;
#pragma unroll
          for (int c = 0; c < CC; ++c)
            if (c < nch) o[c] = v[p][c];
        }
      });
}

// ---------------------------------------------------------------------------
// anal_vpu partials: part[m][chunk][l][c] = sum over the chunk's rings of
// dw_m(r) P_lm(r).  Thread t carries rings chunk0 + k * 128 + t, k < 8,
// and reduces them through the vpu analysis template's shared-memory
// columns (recurrence.cuh).  grid (n_chunks, Mp, ceil(K2 / KC)), block
// kVpuThreads, dynamic shared memory (AnalVpuShape<KC>).
// ---------------------------------------------------------------------------
template <int KC, bool FOLD, bool SPIN>
__global__ void __launch_bounds__(kVpuThreads)
anal_vpu_kernel(const float* __restrict__ dw, const int* __restrict__ m_vals,
                const int* __restrict__ mp_vals, const float* __restrict__ x,
                const float* __restrict__ pmm, const int* __restrict__ pms,
                float* __restrict__ part, int K2, int R, int l_end) {
  using Sh = AnalVpuShape<KC>;
  constexpr int P = FOLD ? 2 : 1;
  constexpr int H = Sh::H;
  constexpr int RT = kVpuRings;
  extern __shared__ __align__(16) float smem[];
  float* red_s = smem;                                 // [O][kStride]
  float* t0 = red_s + Sh::O * Sh::kStride;             // [kLT] x 3
  float* t1 = t0 + kLT;
  float* t2 = t1 + kLT;
  const int mi = blockIdx.y;
  const int chunk = blockIdx.x;
  const int base = chunk * RT * kVpuThreads;
  const int c0 = blockIdx.z * KC;
  const int nch = min(KC, K2 - c0);
  const int m = m_vals[mi];
  if (m < 0) return;                         // block-uniform; reduce zeroes it
  const int mp = SPIN ? mp_vals[mi] : 0;
  const int lz = row_start<SPIN>(m, mp);     // reduce zeroes the rows below
  const int t = threadIdx.x;
  const int ntile = min(RT, (R - base + kVpuThreads - 1) / kVpuThreads);
  const size_t row = static_cast<size_t>(mi) * R;
  const size_t chunk_row =
      (static_cast<size_t>(mi) * gridDim.x + chunk) * l_end;
  // the output this thread reduces at the end of a tile: (j, c) = o, h-th
  // of its H threads
  const int o = t / H, h = t % H;

  float xr[RT];
  float d[RT][P][KC];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int r = base + k * kVpuThreads + t;
    const bool live = k < ntile && r < R;
    xr[k] = live ? x[r] : 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int c = 0; c < KC; ++c)
        d[k][p][c] = (live && c < nch)
            ? dw[((static_cast<size_t>(mi) * P + p) * R + r) * K2 + c0 + c]
            : 0.0f;
  }

  Rec s[RT];
  for (int l0 = lz; l0 < l_end; l0 += kLT) {  // block-uniform
    const int n = min(kLT, l_end - l0);
    fill_coef<SPIN>(l0, m, mp, t0, t1, t2);
    __syncthreads();
    // the seed and (spin 0) P_{m+1,m} peeled off the first tile
    const int j = l0 == lz
        ? vpu_anal_first<KC, P, SPIN>(s, xr, d, ntile, n, m, base, R,
                                      pmm + row, pms + row, red_s)
        : 0;
    if (ntile == RT)                           // block-uniform
      vpu_anal_steps<KC, P, SPIN, true>(s, xr, d, ntile, j, n, t0, t1, t2,
                                        red_s);
    else
      vpu_anal_steps<KC, P, SPIN, false>(s, xr, d, ntile, j, n, t0, t1, t2,
                                         red_s);
    __syncthreads();
    // every output sums its kVpuThreads columns in one fixed order
    const float total = vpu_column_sum<KC>(red_s + o * Sh::kStride + h);
    const int jo = o / KC, c = o % KC;
    if (h == 0 && jo < n && c < nch)
      part[(chunk_row + l0 + jo) * K2 + c0 + c] = total;
  }
}

// ---------------------------------------------------------------------------
// anal_mxu partials: part[m][chunk][l][c] = sum over the chunk's rings of
// dw_m(r) P_lm(r), through the mxu analysis template (mxu_anal.cuh): the
// block copies the chunk's weighted Delta rows channel-major into shared
// memory, then builds, contracts and reduces one panel at a time.
// grid (n_chunks, Mp, ceil(K2 / CC)), block kMxuThreads, dynamic shared
// memory (MxuAnalShape).
// ---------------------------------------------------------------------------
template <int CC, bool FOLD, bool SPIN>
__global__ void __launch_bounds__(kMxuThreads, kMxuBlocksPerSm)
anal_mxu_kernel(const float* __restrict__ dw, const int* __restrict__ m_vals,
                const int* __restrict__ mp_vals, const float* __restrict__ x,
                const float* __restrict__ pmm, const int* __restrict__ pms,
                float* __restrict__ part, int K2, int R, int l_end) {
  using Sh = MxuAnalShape<CC, FOLD, false>;
  constexpr int P = Sh::P;
  extern __shared__ __align__(16) float smem[];   // d_s first
  const int mi = blockIdx.y;
  const int chunk = blockIdx.x;
  const int base = chunk * kMxuChunk;
  const int c0 = blockIdx.z * CC;
  const int nch = min(CC, K2 - c0);
  const int m = m_vals[mi];
  if (m < 0) return;                         // block-uniform; reduce zeroes it
  const int mp = SPIN ? mp_vals[mi] : 0;
  const int lz = row_start<SPIN>(m, mp);     // reduce zeroes the rows below
  const int t = threadIdx.x;
  for (int i = t; i < P * kMxuChunk * CC; i += kMxuThreads) {
    const int c = i % CC, rr = (i / CC) % kMxuChunk, p = i / (CC * kMxuChunk);
    const int r = base + rr;
    smem[(p * CC + c) * Sh::DS + rr] = (r < R && c < nch)
        ? dw[((static_cast<size_t>(mi) * P + p) * R + r) * K2 + c0 + c]
        : 0.0f;
  }
  float xr[kMxuRings];
#pragma unroll
  for (int k = 0; k < kMxuRings; ++k) {
    const int r = base + kMxuRings * t + k;
    xr[k] = r < R ? x[r] : 0.0f;
  }
  const size_t row = static_cast<size_t>(mi) * R;
  float* prow =                              // the chunk's partial rows
      part + (static_cast<size_t>(mi) * gridDim.x + chunk) * l_end * K2 + c0;
  mxu_anal_row<CC, FOLD, SPIN, false>(
      smem, xr, min(kMxuChunk, R - base), m, mp, lz, l_end, pmm + row,
      pms + row, base, R, [&](int l, int c, float v) {
        if (c < nch) prow[static_cast<size_t>(l) * K2 + c] = v;
      });
}

// ---------------------------------------------------------------------------
// anal_reduce: out[row][i] = sum over chunks, in chunk order from 0.0f, of
// part[row][chunk][i], on each row's contiguous (l, c) stretch i < N = L K2,
// for i in the row's kept range [z0, z1); outside it exact zeros, written
// without reading the partials.  Plain rows: z0 = l0 K2 with l0 = m
// (max(m, |m'|) with mp), z0 = N on a padding row (m < 0), z1 = N.  Slot
// streams (seed given): z0 = 0 and z1 = the slot's live end times K2, past
// both segments, whose dead tail the analysis kernels wrote as zeros.
// Thread t of block (x, row) owns the V consecutive floats from
// V (256 x + t), read and written as one V-float vector (16, 8 or 4 bytes).
// grid (ceil(N / (256 V)), rows), block 256.
// Bound by memory bytes: each kept partial is read once and each output
// written once.  The vectors, the row per blockIdx.y (the row's l0 or live
// end read once per warp, no 64-bit index division) and the positions
// written unread keep it streaming; on small shapes the launch's host work
// is the time, not the kernel.
// ---------------------------------------------------------------------------
constexpr int kReduceThreads = 256;

// The rows of one reduce: the plain grid's m (and m') per row, or a slot
// layout's maps (fused.cu's SlotMaps: m, m' of both segments, the position
// segment 1 starts, S for none) and its band limit.
struct ReduceRows {
  const int* m;      // plain: m per row; slots: m of segment 0
  const int* mp;     // m' of the same (spin), or null
  const int* m1;     // slots: m, m' of segment 1
  const int* mp1;
  const int* seed;   // slots only; null on the plain grid
  int l_max;         // slots: the band limit
};

__device__ __forceinline__ int first_l(const int* m, const int* mp, int row) {
  return mp != nullptr ? max(m[row], abs(mp[row])) : m[row];
}

template <int V> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<1> { using T = float; };

template <int V>
__global__ void __launch_bounds__(kReduceThreads)
anal_reduce_kernel(const float* __restrict__ part, const ReduceRows rows,
                   float* __restrict__ out, int n_chunks, int N, int K2) {
  using Vec = typename VecOf<V>::T;
  const int row = blockIdx.y;
  const int i = (blockIdx.x * kReduceThreads + threadIdx.x) * V;
  if (i >= N) return;
  const int L = N / K2;
  int z0 = 0, z1 = N;                      // broadcast loads, one per warp
  if (rows.seed != nullptr) {
    const int sd = rows.seed[row];
    const int len1 =
        sd < L ? rows.l_max + 1 - first_l(rows.m1, rows.mp1, row) : 0;
    const int end = len1 > 0 ? sd + len1
                             : rows.l_max + 1 - first_l(rows.m, rows.mp, row);
    z1 = min(end, L) * K2;
  } else {
    z0 = rows.m[row] < 0 ? N : min(first_l(rows.m, rows.mp, row), L) * K2;
  }
  union { Vec v; float f[V]; } sum, in;
#pragma unroll
  for (int k = 0; k < V; ++k) sum.f[k] = 0.0f;
  if (i + V > z0 && i < z1) {
    const float* p = part + static_cast<size_t>(row) * n_chunks * N + i;
#pragma unroll 4
    for (int ch = 0; ch < n_chunks; ++ch) {
      in.v = *reinterpret_cast<const Vec*>(p + static_cast<size_t>(ch) * N);
#pragma unroll
      for (int k = 0; k < V; ++k) sum.f[k] += in.f[k];
    }
#pragma unroll
    for (int k = 0; k < V; ++k)             // the vector straddles z0 or z1
      if (i + k < z0 || i + k >= z1) sum.f[k] = 0.0f;
  }
  *reinterpret_cast<Vec*>(out + static_cast<size_t>(row) * N + i) = sum.v;
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

template <template <int, bool, bool> class Launch, int kMax, typename Args>
int dispatch(int fold, bool spin, const Args& g) {
  switch (chunk_for(g.K2, kMax)) {
    case 2: return dispatch_flags<Launch, 2>(fold, spin, g);
    case 4: return dispatch_flags<Launch, 4>(fold, spin, g);
    case 8:
      if constexpr (kMax >= 8) return dispatch_flags<Launch, 8>(fold, spin, g);
      break;
    case 16:
      if constexpr (kMax >= 16)
        return dispatch_flags<Launch, 16>(fold, spin, g);
      break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
    constexpr int kRings = synth_rings(KC / 2) * kTile;
    dim3 grid((g.R + kRings - 1) / kRings, g.Mp, (g.K2 + KC - 1) / KC);
    synth_vpu_kernel<KC, FOLD, SPIN><<<grid, kTile, 0, g.stream>>>(
        g.a, g.m_vals, g.mp_vals, g.x, g.pmm, g.pms, g.out, g.L1, g.K2, g.R,
        g.l_end);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int CC, bool FOLD, bool SPIN>
struct LaunchSynthMxu {
  static int run(const SynthArgs& g) {
    using S = MxuSynthShape<CC, FOLD, false>;
    cudaError_t err = cudaFuncSetAttribute(
        synth_mxu_kernel<CC, FOLD, SPIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((g.R + kMxuChunk - 1) / kMxuChunk, g.Mp, (g.K2 + CC - 1) / CC);
    synth_mxu_kernel<CC, FOLD, SPIN><<<grid, kMxuThreads, S::smem_bytes,
                                       g.stream>>>(
        g.a, g.m_vals, g.mp_vals, g.x, g.pmm, g.pms, g.out, g.L1, g.K2, g.R,
        g.l_end);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int KC, bool FOLD, bool SPIN>
struct LaunchAnalVpu {
  static int run(const AnalArgs& g) {
    using S = AnalVpuShape<KC>;
    cudaError_t err = cudaFuncSetAttribute(
        anal_vpu_kernel<KC, FOLD, SPIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(g.n_chunks, g.Mp, (g.K2 + KC - 1) / KC);
    anal_vpu_kernel<KC, FOLD, SPIN><<<grid, kVpuThreads, S::smem_bytes,
                                      g.stream>>>(
        g.dw, g.m_vals, g.mp_vals, g.x, g.pmm, g.pms, g.part, g.K2, g.R,
        g.l_end);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int CC, bool FOLD, bool SPIN>
struct LaunchAnalMxu {
  static int run(const AnalArgs& g) {
    using S = MxuAnalShape<CC, FOLD, false>;
    cudaError_t err = cudaFuncSetAttribute(
        anal_mxu_kernel<CC, FOLD, SPIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(g.n_chunks, g.Mp, (g.K2 + CC - 1) / CC);
    anal_mxu_kernel<CC, FOLD, SPIN><<<grid, kMxuThreads, S::smem_bytes,
                                      g.stream>>>(
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
  return dispatch<LaunchSynthVpu, 16>(fold, mp_vals != nullptr, g);
}

int legendre_synth_mxu(const float* a, const int* m_vals, const int* mp_vals,
                       const float* x, const float* pmm, const int* pms,
                       float* out, int Mp, int L1, int K2, int R, int l_end,
                       int fold, void* stream) {
  SynthArgs g{a, m_vals, mp_vals, x, pmm, pms, out, Mp, L1, K2, R, l_end,
              static_cast<cudaStream_t>(stream)};
  return dispatch<LaunchSynthMxu, 16>(fold, mp_vals != nullptr, g);
}

int legendre_anal_vpu(const float* dw, const int* m_vals, const int* mp_vals,
                      const float* x, const float* pmm, const int* pms,
                      float* part, int Mp, int K2, int R, int l_end,
                      int n_chunks, int fold, void* stream) {
  if (n_chunks != chunks_of(R, kVpuAnalTiles))
    return static_cast<int>(cudaErrorInvalidValue);
  AnalArgs g{dw, m_vals, mp_vals, x, pmm, pms, part, Mp, K2, R, l_end,
             n_chunks, static_cast<cudaStream_t>(stream)};
  return dispatch<LaunchAnalVpu, 4>(fold, mp_vals != nullptr, g);
}

int legendre_anal_mxu(const float* dw, const int* m_vals, const int* mp_vals,
                      const float* x, const float* pmm, const int* pms,
                      float* part, int Mp, int K2, int R, int l_end,
                      int n_chunks, int fold, void* stream) {
  if (n_chunks != chunks_of(R, kMxuAnalTiles))
    return static_cast<int>(cudaErrorInvalidValue);
  AnalArgs g{dw, m_vals, mp_vals, x, pmm, pms, part, Mp, K2, R, l_end,
             n_chunks, static_cast<cudaStream_t>(stream)};
  return dispatch<LaunchAnalMxu, 16>(fold, mp_vals != nullptr, g);
}

// Plain rows: m_vals (mp_vals null for spin 0), m1 = mp1 = seed = null.
// Slot streams: m_vals, mp_vals, m1, mp1, seed the slot maps of segment 0
// and 1 (mp_vals, mp1 null for spin 0) and l_max the band limit.  A null
// m_vals is refused.
int legendre_anal_reduce(const float* part, const int* m_vals,
                         const int* mp_vals, const int* m1, const int* mp1,
                         const int* seed, float* out, int Mp, int n_chunks,
                         int L, int K2, int l_max, void* stream) {
  const long long n = static_cast<long long>(L) * K2;
  if (Mp > 65535 || n < 1 || n > (1LL << 30) || n_chunks < 1 ||
      m_vals == nullptr || (seed != nullptr && m1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int N = static_cast<int>(n);
  const auto aligned = [&](int bytes) {
    return N % (bytes / 4) == 0 &&
           reinterpret_cast<uintptr_t>(part) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(out) % bytes == 0;
  };
  const int V = aligned(16) ? 4 : aligned(8) ? 2 : 1;
  const ReduceRows rows{m_vals, mp_vals, m1, mp1, seed, l_max};
  const dim3 grid((N / V + kReduceThreads - 1) / kReduceThreads, Mp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V == 4)
    anal_reduce_kernel<4><<<grid, kReduceThreads, 0, s>>>(part, rows, out,
                                                           n_chunks, N, K2);
  else if (V == 2)
    anal_reduce_kernel<2><<<grid, kReduceThreads, 0, s>>>(part, rows, out,
                                                           n_chunks, N, K2);
  else
    anal_reduce_kernel<1><<<grid, kReduceThreads, 0, s>>>(part, rows, out,
                                                           n_chunks, N, K2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The scaled float32 Legendre recurrence shared by the port's kernels
// (legendre.cu, fused.cu), so every kernel computes bit-identical P_lm.
//
// P_{l,m} is carried as a (mantissa, scale) pair, P = mant * 2^(64 scale),
// renormalised by 2^+-64 with selects, and a value counts only where
// scale == 0, as in the reference's `_f32_step`
// (src/repro/kernels/legendre_pallas.py:76).  Every operation is a
// separately rounded IEEE one (no contraction, but for the spin update
// below) and 1/sqrt is a correctly rounded square root and division, as in
// the plain PyTorch version (repro_torch/kernels/ref.py): the recurrence
// amplifies a last-bit difference to about 4e-4 of max|Delta| by l_max 256.
//
// The spin branch (the reference's `_f32_step_spin`,
// src/repro/kernels/legendre_pallas.py:116) runs the Wigner-d rows of the
// spin-2 transforms, lam_l = (a_l x + b_l) lam_{l-1} - c_l lam_{l-2}, seeded
// at l0 = max(m, |m'|).  a, b, c depend on (l, m, m') only, so a block fills
// them per 32-l tile into shared memory (fill_spin, the counterpart of
// fill_beta) and each ring's step is two fused multiply-adds (the update
// contracted as XLA's CPU build contracts the reference's), a multiply and
// the rescale.  The
// kernels select the branch with a `bool SPIN` template parameter through
// fill_coef / rec_general (mxu_fill in the mxu templates); their SPIN =
// false instantiations run fill_beta and rec_next.
//
// The header also holds the vpu analysis template's peeled first steps,
// steady steps and fixed-order ring reduction, shared by anal_vpu
// (legendre.cu) and anal_fused_vpu / anal_packed_vpu (fused.cu), and the
// vpu synthesis template's peeled first steps and steady steps, shared by
// synth_vpu (legendre.cu) and synth_fused_vpu / synth_packed_vpu (fused.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 4294967296.0f;                  // 2^32
constexpr float kInvBig = 2.3283064365386963e-10f;     // 2^-32
constexpr float kBig2 = 18446744073709551616.0f;       // 2^64
constexpr float kInvBig2 = 5.421010862427522e-20f;     // 2^-64

constexpr int kTile = 128;     // rings per tile = threads per block
constexpr int kLT = 32;        // l rows per staged tile / panel
constexpr int kVpuAnalTiles = 8;   // anal_vpu: 1024-ring chunks
constexpr int kMxuAnalTiles = 4;   // anal_mxu: 512-ring chunks

// beta_{l,m} and beta_{l,m} / beta_{l-1,m} for l >= m + 2, in float32 as
// `_f32_step` computes them.
__device__ __forceinline__ void beta_pair(int l, int m, float* bl,
                                          float* ratio) {
  const float lf = static_cast<float>(l), mf = static_cast<float>(m);
  const float lb = fmaxf(lf, mf + 2.0f);
  const float b = __fdiv_rn(1.0f, __fsqrt_rn(__fdiv_rn(
      __fsub_rn(__fmul_rn(lb, lb), __fmul_rn(mf, mf)),
      __fsub_rn(__fmul_rn(__fmul_rn(4.0f, lb), lb), 1.0f))));
  const float lb1 = fmaxf(lf - 1.0f, mf + 1.0f);
  const float b1 = __fdiv_rn(1.0f, __fsqrt_rn(__fdiv_rn(
      __fsub_rn(__fmul_rn(lb1, lb1), __fmul_rn(mf, mf)),
      __fsub_rn(__fmul_rn(__fmul_rn(4.0f, lb1), lb1), 1.0f))));
  *bl = b;
  *ratio = __fdiv_rn(b, b1);
}

// Threads below kLT fill the block's beta table for rows l0 .. l0 + kLT - 1.
__device__ __forceinline__ void fill_beta(int l0, int m, float* bl_s,
                                          float* ratio_s) {
  if (threadIdx.x < kLT) {
    const int l = l0 + static_cast<int>(threadIdx.x);
    float bl = 0.0f, ratio = 0.0f;
    if (l >= m + 2) beta_pair(l, m, &bl, &ratio);
    bl_s[threadIdx.x] = bl;
    ratio_s[threadIdx.x] = ratio;
  }
}

// The (mantissa, scale) carry of one ring.
struct Rec {
  float pp = 0.0f;   // P_{l-2} mantissa
  float pc = 0.0f;   // P_{l-1} mantissa
  int sc = 0;        // shared scale
};

// Rescale and descale after the new mantissa `c` was formed (not at a seed).
__device__ __forceinline__ float rec_finish(Rec* s, float c) {
  float p = s->pc;
  int sc = s->sc;
  if (fabsf(c) > kBig && sc < 0) {
    c = c * kInvBig2;
    p = p * kInvBig2;
    sc += 1;
  }
  if (fabsf(c) < kInvBig && fabsf(p) < kInvBig) {
    c = c * kBig2;
    p = p * kBig2;
    sc -= 1;
  }
  s->pp = p;
  s->pc = c;
  s->sc = sc;
  return sc == 0 ? c : 0.0f;
}

// The seed at l == lz: the host's (mantissa, scale) pair of P_{lz}.
__device__ __forceinline__ float rec_seed(Rec* s, float pmm, int pms) {
  float c = pmm;
  int sc = pms;
  if (fabsf(c) > kBig && sc < 0) {
    c = c * kInvBig2;
    sc += 1;
  }
  s->pp = 0.0f;
  s->pc = c;
  s->sc = sc;
  return sc == 0 ? c : 0.0f;
}

// The new mantissa of P_{m+1,m} = sqrt(2m+3) x P_mm (p1 = sqrt(2m+3)).
__device__ __forceinline__ float first_mant(const Rec* s, float x, float p1) {
  return __fmul_rn(__fmul_rn(p1, x), s->pc);
}

// The new mantissa of the three-term step at l >= m + 2, with beta_l (bl)
// and beta_l / beta_{l-1} (ratio).
__device__ __forceinline__ float next_mant(const Rec* s, float x, float bl,
                                           float ratio) {
  return __fsub_rn(__fmul_rn(__fmul_rn(bl, x), s->pc),
                   __fmul_rn(ratio, s->pp));
}

// The step at l == m + 1 alone, and the three-term step alone (l >= m + 2),
// each ending in one rec_finish: the kernels peel the seed and the first
// step off their l loops, so the steady step has no branch (a rescale in
// each branch of one step for every l cost kernel 9 15% on the H100).
__device__ __forceinline__ float rec_first(Rec* s, float x, float p1) {
  return rec_finish(s, first_mant(s, x, p1));
}

__device__ __forceinline__ float rec_next(Rec* s, float x, float bl,
                                          float ratio) {
  return rec_finish(s, next_mant(s, x, bl, ratio));
}

__device__ __forceinline__ float p_first_coef(int m) {
  return __fsqrt_rn(fmaxf(2.0f * static_cast<float>(m) + 3.0f, 0.0f));
}

// The Wigner-d coefficients a_l, b_l, c_l of row (m, m') at l, in float32
// as `_f32_step_spin` computes them: every operation separately rounded, in
// the plain version's order.  l0 = max(m, |m'|); at l = l0 + 1, c = 0.
__device__ __forceinline__ void spin_coef(int l, int m, int mp, float* a,
                                          float* b, float* c) {
  const float lf = static_cast<float>(l), mf = static_cast<float>(m),
              mpf = static_cast<float>(mp);
  const float l0 = fmaxf(mf, fabsf(mpf));
  const float ls = fmaxf(lf, __fadd_rn(l0, 1.0f));
  const float mm = __fmul_rn(mf, mf), mpmp = __fmul_rn(mpf, mpf);
  const float ls2 = __fmul_rn(ls, ls);
  const float d2 = fmaxf(__fmul_rn(__fsub_rn(ls2, mm), __fsub_rn(ls2, mpmp)),
                         1e-30f);
  const float lm1 = __fsub_rn(ls, 1.0f);
  const float lm12 = __fmul_rn(lm1, lm1);
  const float d2m1 = fmaxf(
      __fmul_rn(__fsub_rn(lm12, mm), __fsub_rn(lm12, mpmp)), 0.0f);
  const float s2l = __fsqrt_rn(__fsub_rn(__fmul_rn(__fmul_rn(4.0f, ls), ls),
                                         1.0f));
  const float inv_d = __fdiv_rn(1.0f, __fsqrt_rn(d2));
  const float inv_lm1 = __fdiv_rn(1.0f, fmaxf(lm1, 1.0f));
  *a = __fmul_rn(__fmul_rn(ls, s2l), inv_d);
  *b = __fmul_rn(__fmul_rn(__fmul_rn(-__fmul_rn(mf, mpf), s2l), inv_d),
                 inv_lm1);
  const float q = __fsqrt_rn(__fdiv_rn(
      __fadd_rn(__fmul_rn(2.0f, ls), 1.0f),
      fmaxf(__fsub_rn(__fmul_rn(2.0f, ls), 3.0f), 1.0f)));
  *c = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(q, ls), __fsqrt_rn(d2m1)),
                           inv_d),
                 inv_lm1);
}

// Threads below kLT fill the block's Wigner-d table for rows
// l0 .. l0 + kLT - 1 of row (m, m').
__device__ __forceinline__ void fill_spin(int l0, int m, int mp, float* a_s,
                                          float* b_s, float* c_s) {
  if (threadIdx.x < kLT) {
    float a, b, c;
    spin_coef(l0 + static_cast<int>(threadIdx.x), m, mp, &a, &b, &c);
    a_s[threadIdx.x] = a;
    b_s[threadIdx.x] = b;
    c_s[threadIdx.x] = c;
  }
}

// The Wigner-d step after the seed: lambda_l = (a x + b) lambda_{l-1}
// - c lambda_{l-2} (at lz + 1, c = 0 and lambda_{l-2} = 0), contracted
// into two fused multiply-adds as XLA's CPU build contracts the
// reference's update, and as `kernels/ref.py` `fma_f32` rounds it:
// fma(fma(a, x, b), lambda_{l-1}, -(c lambda_{l-2})).
__device__ __forceinline__ float rec_next_spin(Rec* s, float x, float a,
                                               float b, float c) {
  return rec_finish(s, fmaf(fmaf(a, x, b), s->pc, -__fmul_rn(c, s->pp)));
}

// The coefficient table of one 32-l tile of a row: beta and the beta ratio
// in t0, t1 (spin 0), or a, b, c in t0, t1, t2 (spin).
template <bool SPIN>
__device__ __forceinline__ void fill_coef(int l0, int m, int mp, float* t0,
                                          float* t1, float* t2) {
  if constexpr (SPIN) {
    fill_spin(l0, m, mp, t0, t1, t2);
  } else {
    fill_beta(l0, m, t0, t1);
  }
}

// First multipole of row (m, m'): m for spin 0, max(m, |m'|) for spin.
template <bool SPIN>
__device__ __forceinline__ int row_start(int m, int mp) {
  if constexpr (SPIN) {
    return max(m, abs(mp));
  } else {
    return m;
  }
}

// The steady step of row (m, m') at tile entry j: the three-term
// recurrence past the seed (spin: past lz; spin 0: past m + 1).
template <bool SPIN>
__device__ __forceinline__ float rec_general(Rec* s, float x,
                                             const float* t0,
                                             const float* t1,
                                             const float* t2, int j) {
  if constexpr (SPIN) {
    return rec_next_spin(s, x, t0[j], t1[j], t2[j]);
  } else {
    return rec_next(s, x, t0[j], t1[j]);
  }
}

// ---------------------------------------------------------------------------
// The vpu analysis template's ring reduction, shared by anal_vpu
// (legendre.cu, kernel 3) and anal_fused_vpu / anal_packed_vpu (fused.cu,
// kernels 11 and 7).  A block of kVpuThreads threads carries a chunk of
// kVpuAnalTiles x kTile rings, kVpuRings per thread at chunk0 + k *
// kVpuThreads + t.  Per l each thread adds its rings' products in k order
// and stores the sum per channel into its column of the tile's reduction
// rows red_s; once per 32-l tile every output (l, c) sums its kVpuThreads
// columns in one fixed order (vpu_column_sum): no atomics, no per-l
// shuffle chain, the same bits on every run.
// ---------------------------------------------------------------------------
constexpr int kVpuThreads = 128;
constexpr int kVpuRings = kVpuAnalTiles * kTile / kVpuThreads;

// The reduction rows of CC channels: O outputs a tile, H threads an output,
// rows padded to kStride floats (conflict-free), and the dynamic shared
// memory of the rows and three 32-entry coefficient tables.
template <int CC_>
struct AnalVpuShape {
  static constexpr int CC = CC_;
  static constexpr int O = kLT * CC;                // outputs of a tile
  static constexpr int H = kVpuThreads / O;         // threads per output
  static constexpr int kStride = kVpuThreads + H;   // conflict-free rows
  static constexpr size_t smem_bytes =
      (static_cast<size_t>(O) * kStride + 3 * kLT) * sizeof(float);
  static_assert(H >= 1 && kVpuThreads % O == 0, "one output per H threads");
};

// The first steps of a row's first tile (tile entries 0 and 1): the seed
// at lz (plane 0; its seeds pmm[r], pms[r] read here and dropped), then,
// for spin 0 and n > 1, P_{m+1,m} (plane P - 1), each of the thread's rings
// below ntile adding its products into the thread's column of red_s.
// Returns the first entry left to the steady steps.
template <int CC, int P, bool SPIN>
__device__ __forceinline__ int vpu_anal_first(
    Rec (&s)[kVpuRings], const float (&xr)[kVpuRings],
    const float (&d)[kVpuRings][P][CC], int ntile, int n, int m, int base,
    int R, const float* __restrict__ pmm, const int* __restrict__ pms,
    float* red_s) {
  constexpr int kStride = AnalVpuShape<CC>::kStride;
  const int t = threadIdx.x;
  float sum[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) sum[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < kVpuRings; ++k) {
    if (k < ntile) {
      const int r = base + k * kVpuThreads + t;
      const bool live = r < R;
      const float v = rec_seed(&s[k], live ? pmm[r] : 0.0f,
                               live ? pms[r] : 0);
#pragma unroll
      for (int c = 0; c < CC; ++c) sum[c] = fmaf(v, d[k][0][c], sum[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CC; ++c) red_s[c * kStride + t] = sum[c];
  if (SPIN || n < 2) return 1;
  const float p1 = p_first_coef(m);
#pragma unroll
  for (int c = 0; c < CC; ++c) sum[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < kVpuRings; ++k) {
    if (k < ntile) {
      const float v = rec_first(&s[k], xr[k], p1);
#pragma unroll
      for (int c = 0; c < CC; ++c) sum[c] = fmaf(v, d[k][P - 1][c], sum[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CC; ++c) red_s[(CC + c) * kStride + t] = sum[c];
  return 2;
}

// The steady steps j0 <= j < n of one tile: each of the thread's rings
// (those below ntile unless FULL) advances by the three-term recurrence and
// adds its products into the thread's column of red_s.  With the fold, even
// j is plane 0 and odd j plane P - 1 (the tile starts at an even l - m).
template <int CC, int P, bool SPIN, bool FULL>
__device__ __forceinline__ void vpu_anal_steps(
    Rec (&s)[kVpuRings], const float (&xr)[kVpuRings],
    const float (&d)[kVpuRings][P][CC], int ntile, int j, int n,
    const float* t0, const float* t1, const float* t2, float* red_s) {
  constexpr int kStride = AnalVpuShape<CC>::kStride;
  float* col = red_s + threadIdx.x;
  auto step = [&](int jj, int p) {
    float sum[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) sum[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < kVpuRings; ++k) {
      if (FULL || k < ntile) {
        const float v = rec_general<SPIN>(&s[k], xr[k], t0, t1, t2, jj);
#pragma unroll
        for (int c = 0; c < CC; ++c) sum[c] = fmaf(v, d[k][p][c], sum[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CC; ++c) col[(jj * CC + c) * kStride] = sum[c];
  };
  for (; j + 1 < n; j += 2) {
    step(j, 0);
    step(j + 1, P - 1);
  }
  if (j < n) step(j, 0);
}

// One output's sum of its kVpuThreads columns in a fixed order: `row`
// points at the output's reduction row, offset by the thread's rank h < H
// among the output's threads; four interleaved partial sums over the
// thread's share, then the H threads by an xor butterfly (every lane of the
// warp takes part).
template <int CC>
__device__ __forceinline__ float vpu_column_sum(const float* row) {
  constexpr int H = AnalVpuShape<CC>::H;
  float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kVpuThreads / H; i += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] += row[(i + u) * H];
  }
  float total = (q[0] + q[1]) + (q[2] + q[3]);
#pragma unroll
  for (int off = 1; off < H; off <<= 1)
    total += __shfl_xor_sync(0xffffffffu, total, off);
  return total;
}

// ---------------------------------------------------------------------------
// The vpu synthesis template, shared by synth_vpu (legendre.cu, kernel 1)
// and synth_fused_vpu / synth_packed_vpu (fused.cu, kernels 9 and 5).  A
// block of kTile threads carries RT = synth_rings(maps) ring tiles, thread
// t the rings base + k * kTile + t, each with its accumulators acc[k][plane]
// [channel] in registers; per 32-l tile the kernel stages the tile's
// coefficient rows a_s and its recurrence table, then the first steps
// (the row's first tile only) and the steady steps add each ring's
// products in ascending l: every sum is one fmaf chain from 0.0f.
// ---------------------------------------------------------------------------

// Rings a thread carries at map chunk km (channel chunk 2 km): 4 at km 1
// and 2, 8 / km above, so the accumulators (RT x P x 2 km) stay at <= 32
// floats.
__host__ __device__ constexpr int synth_rings(int km) {
  return km <= 2 ? 4 : 8 / km;
}

// The first steps of a row's first tile: the seed at lz (plane 0; its
// seeds pmm[r], pms[r] read here), then, for spin 0 and n > 1, P_{m+1,m}
// (plane P - 1), each of the thread's rings below ntile adding its
// products, each sum starting as fmaf(v, a, 0.0f) as in the steady steps.
// Returns the first entry left to the steady steps.
template <int RT, int CC, int P, bool SPIN>
__device__ __forceinline__ int vpu_synth_first(
    Rec (&s)[RT], const float (&xr)[RT], float (&acc)[RT][P][CC], int ntile,
    int n, int m, int base, int R, const float* __restrict__ pmm,
    const int* __restrict__ pms, const float (*a_s)[CC]) {
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    if (k < ntile) {
      const int r = base + k * kTile + static_cast<int>(threadIdx.x);
      const bool live = r < R;
      const float v = rec_seed(&s[k], live ? pmm[r] : 0.0f,
                               live ? pms[r] : 0);
#pragma unroll
      for (int c = 0; c < CC; ++c)
        acc[k][0][c] = fmaf(v, a_s[0][c], acc[k][0][c]);
    }
  }
  if (SPIN || n < 2) return 1;
  const float p1 = p_first_coef(m);
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    if (k < ntile) {
      const float v = rec_first(&s[k], xr[k], p1);
#pragma unroll
      for (int c = 0; c < CC; ++c)
        acc[k][P - 1][c] = fmaf(v, a_s[1][c], acc[k][P - 1][c]);
    }
  }
  return 2;
}

// The steady steps j0 <= j < n of one tile: each of the thread's rings
// (those below ntile unless FULL) advances by the three-term recurrence and
// adds its products to its accumulators, the tile's coefficient row read
// once for all of them.  With the fold, even j is plane 0 and odd j plane
// P - 1 (the tile starts at an even l - m).
template <int RT, int CC, int P, bool SPIN, bool FULL>
__device__ __forceinline__ void vpu_synth_steps(
    Rec (&s)[RT], const float (&xr)[RT], float (&acc)[RT][P][CC], int ntile,
    int j, int n,
    const float* t0, const float* t1, const float* t2,
    const float (*a_s)[CC]) {
  auto step = [&](int jj, int p) {
    float a[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) a[c] = a_s[jj][c];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      if (FULL || k < ntile) {
        const float v = rec_general<SPIN>(&s[k], xr[k], t0, t1, t2, jj);
#pragma unroll
        for (int c = 0; c < CC; ++c) acc[k][p][c] = fmaf(v, a[c], acc[k][p][c]);
      }
    }
  };
  for (; j + 1 < n; j += 2) {
    step(j, 0);
    step(j + 1, P - 1);
  }
  if (j < n) step(j, 0);
}

// Map (or channel) chunk per block: the smallest power of two >= n, from
// `lo`, capped at `cap`.
inline int chunk_for(int n, int cap, int lo = 2) {
  int kc = lo;
  while (kc < n && kc < cap) kc *= 2;
  return kc;
}

// Ring chunks of the analysis partials; the Python wrappers (ANAL_CHUNK in
// legendre_cuda.py) size the buffer, the launchers check it agrees.
inline int chunks_of(int R, int tiles) {
  return (R + tiles * kTile - 1) / (tiles * kTile);
}

}  // namespace
